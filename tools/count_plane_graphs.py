"""The plane stage's CUDA-graph counts (models/plane_graphs) in a benchmark
cell: in its set-up and in units of its closed loop.

    python3 tools/count_plane_graphs.py --workload video.ide3d-ffhq512 [--seed N] [--units 4]

Runs the cell's set-up as gpubench/run.py does (its warm-up included), then
`--units` units of the cell's work, and prints one JSON line with the counts
of each: graphs captured, calls replayed, calls run eager. Exits 1 when a unit
captured a graph, which would put a capture inside the measured window. Needs
a CUDA card; run it from the root of a checkout.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--units", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from gpubench import harness
    from ide3d_tpu_torch.models import plane_graphs

    run = harness.make_run(ROOT, args.workload, args.seed, 0.0, False, "cuda", time.perf_counter())
    mod = importlib.import_module(f"gpubench.kinds.{run.traffic['kind']}")
    plane_graphs.reset_counts()
    st = mod.setup(run)
    setup = plane_graphs.counts()
    plane_graphs.reset_counts()
    for i in range(args.units):
        mod.unit(st, i)
    torch.cuda.synchronize()
    units = plane_graphs.counts()
    print(json.dumps({"workload": args.workload, "seed": args.seed, "setup": setup,
                      "units": args.units, "in_units": units}))
    return 1 if units["captures"] else 0


if __name__ == "__main__":
    sys.exit(main())
