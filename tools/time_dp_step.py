"""Times the flagship GAN train step and the `train_gan` loop of one checkout
of the port: the step without a group and, where the checkout has the
data-parallel layer (`parallel/mesh.py`), the same step under a real group of
one rank over NCCL.

    python3 tools/time_dp_step.py [--tree DIR] [--turns N] [--loop-steps N] [--data DIR]

Imports `ide3d_tpu_torch` from DIR (default: the checkout this script is in),
so that two commits are timed on the same card, one process each: unpack the
other commit with `git archive <commit> | tar -x -C DIR`, and run this script
for both trees in turns (other, this, this, other) in one GPU-tool call. Only
entry points that every version of the port since its training step has are
called.

step: the flagship G and D (bf16, `GeneratorConfig()`) at global batch 4 of
random 512² images, ADA at p 0.2, neither R1 nor PL (state.step is set to 1
before each step), one state for every kind. The kinds run in turns (plain,
dp, dp, plain; N turns), one step a measurement, timed by CUDA events with
the card idle before each; the first step of each kind is left out.

loop: `train_gan.main` at `--preset full --batch 4` on a synthetic 512²
dataset (`tools/torch_make_synthetic_dataset.py`, 4 identities x 2 views,
made once when --data is not given), adaptive ADA, for --loop-steps steps.
The step function is wrapped to note the host clock as each step is called;
the loop's rate is read from the intervals between those calls after the
first LOOP_WARM steps (the loader, the prefetch, the stats and the ADA
readback every 4 steps all fall between two calls).

Prints one line for each, with the card's name and power limit, then one JSON
line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
BATCH, ADA_P = 4, 0.2
LOOP_WARM = 5


def _smoke_helpers():
    """chip_smoke.py of this checkout (DIR may hold a chip_smoke.py of its own)."""
    spec = importlib.util.spec_from_file_location("dp_timing_helpers", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _has_mesh() -> bool:
    return importlib.util.find_spec("ide3d_tpu_torch.parallel.mesh") is not None


def _event_ms(fn) -> float:
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_steps(smoke, turns: int, group=None) -> dict:
    """{kind: [event ms, ...]} of the step in turns."""
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.train import gan

    cfg = GeneratorConfig()
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution**2 / BATCH)
    G = Ide3dGenerator(cfg).init(seed=0).cuda()
    D = Discriminator(DiscriminatorConfig(img_channels=gan.d_input_channels(tcfg, cfg)))
    state = gan.init_gan_state(G, D.init(1).cuda(), tcfg)
    steps = {"plain": gan.make_gan_train_step(tcfg)}
    if group is not None:
        steps["dp"] = gan.make_gan_train_step(tcfg, group)
    batch = smoke.synthetic_batch(BATCH, cfg.img_resolution, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(steps) + (["plain", "dp", "dp", "plain"] if group is not None
                           else ["plain"]) * turns
    ms = {k: [] for k in steps}
    for i, kind in enumerate(order):
        state.step = 1

        def one():
            _, stats = steps[kind](state, batch, gen, ADA_P)
            return stats

        t = _event_ms(one)
        if i >= len(steps):
            ms[kind].append(t)
    return ms


def _under_group(fn, *args):
    from ide3d_tpu_torch.parallel import mesh

    return mesh.launch(fn, 1, "cuda", *args)


def _steps_in_group(group, smoke, turns):
    return time_steps(smoke, turns, group)


def make_data(root: str) -> str:
    out = str(Path(root) / "sphere")
    subprocess.run([sys.executable, str(ROOT / "tools" / "torch_make_synthetic_dataset.py"),
                    "--out", out, "--identities", "4", "--views", "2", "--resolution", "512"],
                   check=True, capture_output=True, text=True, timeout=600)
    return out


def time_loop(data: str, steps: int, outdir: str) -> dict:
    """The intervals (ms) between the loop's step calls, after LOOP_WARM."""
    from ide3d_tpu_torch.apps import train_gan
    from ide3d_tpu_torch.train import gan

    calls = []
    real = gan.make_gan_train_step

    def wrapped(*args, **kw):
        step = real(*args, **kw)

        def noted(*a, **k):
            calls.append(time.perf_counter())
            return step(*a, **k)

        return noted

    gan.make_gan_train_step = wrapped
    try:
        train_gan.main(["--data", str(Path(data) / "img"), "--seg", str(Path(data) / "seg"),
                        "--outdir", outdir, "--preset", "full", "--batch", str(BATCH),
                        "--kimg", str(steps * BATCH / 1000), "--snap-kimg", "1000",
                        "--grid-kimg", "1000", "--device", "cuda"])
    finally:
        gan.make_gan_train_step = real
    if len(calls) != steps:
        raise RuntimeError(f"train_gan called the step {len(calls)} times, want {steps}")
    gaps = np.diff(calls[LOOP_WARM:]) * 1e3
    return {"interval_ms": [float(g) for g in gaps],
            "median_ms": float(np.median(gaps)),
            "steps_per_s": float(1e3 / gaps.mean())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="root of the checkout to time")
    ap.add_argument("--turns", type=int, default=6, help="turns of the step (0: none)")
    ap.add_argument("--loop-steps", type=int, default=40, help="steps of the loop (0: none)")
    ap.add_argument("--data", default=None, help="a synthetic dataset (made when not given)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    smoke = _smoke_helpers()
    smi = smoke.phase_device().splitlines()[0]
    result = {"tree": str(args.tree), "device": smi, "has_mesh": _has_mesh()}
    if args.turns:
        ms = (_under_group(_steps_in_group, smoke, args.turns) if result["has_mesh"]
              else time_steps(smoke, args.turns))
        result["step"] = {k: {"ms": v, "median_ms": statistics.median(v)} for k, v in ms.items()}
        print(f"step {args.tree} batch {BATCH} ({smi}): "
              + ", ".join(f"{k} median {v['median_ms']:.3f} ms of {v['ms']}"
                          for k, v in result["step"].items()), flush=True)
        torch.cuda.empty_cache()
    if args.loop_steps:
        with tempfile.TemporaryDirectory() as root:
            data = args.data or make_data(root)
            loop = time_loop(data, args.loop_steps, str(Path(root) / "run"))
        result["loop"] = loop
        print(f"train_gan loop {args.tree} batch {BATCH} ({smi}): {loop['steps_per_s']:.4f} "
              f"steps/s, median interval {loop['median_ms']:.3f} ms over "
              f"{len(loop['interval_ms'])} intervals", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
