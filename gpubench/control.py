"""Readings that the limits of `correct` are set from, for one cell.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 [--seconds 2]

For each seed, one run of the cell as the benchmark makes it (a short window
at the cell's own load), printing each compared number of the program (the
lower readings) and of the control: the reference put in the program's place
and computed one precision below the configuration's (the upper readings).
The benchmark's own runs never run the control. Ends with one JSON line.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gpubench.run  # noqa: E402,F401  (the caches' fixed paths)


def main(argv=None) -> int:
    import argparse
    import json

    from gpubench import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.make_run(gpubench.run.ROOT, args.workload, seed, args.seconds, False,
                               args.device, time.perf_counter())
        run.control = True
        res = harness.run_cell(run)
        row = {"seed": seed, "correct": res["correct"],
               **{k: c["value"] for k, c in res["checks"].items()}, **res.get("control", {})}
        print(json.dumps(row), flush=True)
        rows.append(row)
    keys = [k for k in rows[0] if k not in ("seed", "correct") and isinstance(rows[0][k], (int, float))]
    summary = {k: {"min": min(r[k] for r in rows), "max": max(r[k] for r in rows)} for k in keys}
    print(json.dumps({"workload": args.workload, "seeds": len(rows), "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
