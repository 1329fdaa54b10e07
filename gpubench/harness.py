"""The benchmark's loop: one cell, one seed, one closed-loop window.

BENCHMARK.json names each cell's configuration and traffic mix. The harness
reads `configs/<config>.json` (the sizes and init rules), the traffic mix's
data file `traffic/<traffic>.json`, whose `kind` names the general generator
`kinds/<kind>.py` that turns the mix's parameters into work, and the cell's
limits `limits/<cell>.json`. A per-layer metric `<family>.<suffix>` is read by
`layers/<family>.py`. A new cell, configuration, mix or metric of a kind that
exists is new files only.

A kind's module provides:
  setup(run) -> state          build the program, its weights and traffic from
                               the seed, and warm up every shape it will use
  unit(state, i)               the i-th unit of closed-loop work in the window
  snapshot(state) -> dict      its counts as the window closes
  finish(state, run, win)      after the window and the traced stretch:
                               {"attempted", "failed", "e2e": {metric: value},
                               "work": {name: count in the window,
                               "k1_batch": the batch of its K1 launches}}
  check(state, run, win)       after the device peak is read: frees the
                               program and compares what the window produced
                               with the plain reference -> {number: value}
and may provide
  work(state, win) -> dict     work counted only by the check (its FLOPs)
  timed(state)                 after a traced run's stretch: timings that
                               synchronize each step
and, on the state, `trace_units`: the units that a traced run profiles after
its window, once everything is warm.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

BANNED = ("jax", "jaxlib", "flax", "ide3d_tpu")


def banned_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is banned."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


@dataclasses.dataclass
class Run:
    root: str
    bench: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    control: bool = False  # the check also reads the lower-precision control (control.py)


@dataclasses.dataclass
class Window:
    seconds: float = 0.0  # wall time of the whole window
    trace_s: float = 0.0  # wall time of the traced stretch
    trace_stats: object = None  # trace.TraceStats
    snapshot: dict = dataclasses.field(default_factory=dict)  # the kind's counts at the close


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def make_run(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str,
             t0: float, overrides: Optional[dict] = None) -> Run:
    """The run of `workload`; `overrides` replaces parts of the configuration,
    traffic or limits (the CPU tests' small sizes)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = find(bench["workloads"], workload, "workload")
    cfg_entry = find(bench["configs"], cell["config"], "config")
    here = os.path.dirname(os.path.abspath(__file__))
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", workload + ".json"))
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic, "limits": limits}[key].update(part)
    return Run(root=root, bench=bench, cell=cell, config=config, traffic=traffic, limits=limits,
               seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device, t0=t0)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def run_window(run: Run, mod, st) -> Window:
    """Closed-loop units for `run.seconds`, then, in a traced run, `trace_units`
    more under the profiler: the window's own readings are taken without it."""
    from . import trace as tracing
    from .kinds.common import synchronize

    win = Window()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < run.seconds:
        mod.unit(st, i)
        i += 1
    synchronize(run.device)
    win.seconds = time.perf_counter() - start
    win.snapshot = mod.snapshot(st)
    if run.trace:
        prof = tracing.Profile(run.device)
        prof.start()
        tp0 = time.perf_counter()
        for _ in range(st.trace_units):
            mod.unit(st, i)
            i += 1
        synchronize(run.device)
        win.trace_s = time.perf_counter() - tp0
        prof.stop()
        win.trace_stats = prof.summarize()
        if hasattr(mod, "timed"):
            mod.timed(st)
    return win


def device_info(run: Run, chips: int, win: Window) -> dict:
    import torch

    if run.device.startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips))}
        info["power_limit"] = power_limit()
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace and win.trace_stats is not None:
        info["busy_s"] = win.trace_stats.busy_s
        info["window_s"] = win.trace_s
    return info


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def run_cell(run: Run) -> dict:
    """Set-up, window, readings and check of one run -> the result object."""
    mod = importlib.import_module(f"gpubench.kinds.{run.traffic['kind']}")
    st = mod.setup(run)
    setup_s = time.perf_counter() - run.t0
    win = run_window(run, mod, st)
    out = mod.finish(st, run, win)
    e2e = dict(out["e2e"], setup_s=setup_s)
    chips = int(run.cell["chips"])
    device = device_info(run, chips, win)

    numbers = mod.check(st, run, win)
    control = {k: v for k, v in numbers.items() if k.startswith("control.")}
    checks = {k: {"value": v, "limit": run.limits[k]} for k, v in numbers.items() if k not in control}
    correct = (bool(checks) and out["failed"] == 0 and out["attempted"] > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    if run.trace:
        work = dict(out["work"], **(mod.work(st, win) if hasattr(mod, "work") else {}))
        ctx = {"run": run, "win": win, "work": work, "trace": win.trace_stats, "state": st}
        for m in run.bench["per_layer"]:
            if not applies(m, run.cell["name"]):
                continue
            family = m["name"].split(".")[0]
            reader = importlib.import_module(f"gpubench.layers.{family}")
            value = reader.read(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in run.bench["end_to_end"]:
            if applies(m, run.cell["name"]):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if run.trace and win.trace_stats is not None:
        result["breakdown"] = win.trace_stats.breakdown()
    if control:
        result["control"] = control
    result["checks"] = checks
    return result


def main(argv: list, root: str, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    run = make_run(root, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    chips = int(run.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    result = run_cell(run)
    found = banned_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}; the port must not", file=sys.stderr)
        return 4
    emit(result)
    return 0


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
