"""Times K1 (`sort_integrate`) of one checkout of the port at the frame's shape.

    python3 tools/time_k1.py [--tree DIR]

Imports `ide3d_tpu_torch` from DIR (default: the checkout this script is in),
so that two commits' kernels are timed on the same card, one process each:
unpack the other commit with `git archive <commit> | tar -x -C DIR`.
It calls only the entry point `sort_integrate(z_a, vals_a, z_b, vals_b,
ray_norm)`, which every version of the port has, and the kernel is built from
DIR's own source. At bf16 values, R=4096, S=96+96, C+1=52, for B=1 and B=3,
with halves sorted (as the deterministic frame has them) and unsorted (a
render with a generator), it holds the kernel against the plain version
(max abs err <= 1e-3) and prints, with chip_smoke.py's timers:
  graph_ms  device time per call, from a CUDA graph of 20 calls over two input sets
  eager_ms  time between CUDA events around one eager call (host + kernel)
  host_ms   host time of one eager call until it returns
one line per case, then one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _smoke_helpers():
    """chip_smoke.py of this checkout (DIR may hold a chip_smoke.py of its own)."""
    spec = importlib.util.spec_from_file_location("k1_timing_helpers", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="root of the checkout to time")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from ide3d_tpu_torch.ops.ray_march import sort_integrate, sort_integrate_plain

    smoke = _smoke_helpers()
    smi = smoke.phase_device().splitlines()[0]
    gen = torch.Generator().manual_seed(1)
    result = {"tree": str(args.tree), "device": smi}
    for B in (1, 3):
        for halves in ("sorted", "unsorted"):
            sets = [smoke.k1_inputs(gen, torch.bfloat16, B=B, sorted_halves=halves == "sorted")
                    for _ in range(2)]
            err = smoke.max_err(sort_integrate(*sets[0]), sort_integrate_plain(*sets[0]))
            if err > 1e-3:
                raise RuntimeError(f"B={B} {halves}: max abs err vs plain {err} > 1e-3")
            calls = [lambda a=a: sort_integrate(*a) for a in sets]
            graph = smoke.graph_ms(calls, 20)
            eager, host = smoke.eager_ms(calls[0])
            nbytes = smoke.k1_bytes(sets[0])
            bound = nbytes / smoke.HBM_BYTES_PER_MS
            result[f"B{B}_{halves}"] = {"graph_ms": graph, "eager_ms": eager, "host_ms": host,
                                        "bytes": nbytes, "bound_ms": bound, "max_abs_err": err}
            print(f"K1 {args.tree} B={B} {halves} halves, bf16 R=4096 S=96+96 C=51 ({smi}): "
                  f"graph {graph:.4f} ms ({100 * bound / graph:.1f}% of the {bound * 1e3:.2f} us "
                  f"bound), eager {eager:.4f} ms, host {host:.4f} ms; max abs err {err:.3g}",
                  flush=True)
            del sets, calls
    print(json.dumps(result))


if __name__ == "__main__":
    main()
