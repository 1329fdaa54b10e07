"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic mix
are looked up by name in BENCHMARK.json (see gpubench/harness.py).
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up counts from here

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "gpubench")
# Every compile cache at a fixed path inside the checkout, set before torch is
# imported: bytecode (a read-only Python installation keeps none for torch),
# Triton, torch extensions and inductor, and the CUDA JIT cache.
sys.pycache_prefix = os.path.join(CACHE, "pycache")
sys.dont_write_bytecode = False
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_jit")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from gpubench import harness

    sys.exit(harness.main(sys.argv[1:], ROOT, T0))
