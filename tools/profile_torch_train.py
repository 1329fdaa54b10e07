"""Where the time of the port's GAN train step goes, on one CUDA card.

    python3 tools/profile_torch_train.py [--batch 4] [--steps 3] [--out out]

GeneratorConfig() and Discriminator(img_channels=25), random weights, bf16,
96+96 samples, ada_p 0.2, a synthetic 512² batch (chip_smoke.synthetic_batch).
After warm-up steps, prints from CUDA events (median over --steps):
  * a step without R1 and a step with R1,
  * their parts: the G phase (G forward + D on the fakes + backward + Adam +
    EMA), the D loss and its backward, R1 (double backward) and its gradient,
then profiles one step of each kind with torch.profiler: the top kernels and
the top operators by device time, and the device's busy share. The full tables
go to <out>/profile_train_{plain,r1}.txt. Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import synthetic_batch  # noqa: E402
from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig  # noqa: E402
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator  # noqa: E402
from ide3d_tpu_torch.train import gan  # noqa: E402

ADA_P = 0.2


def timed(fn, n: int) -> float:
    """Median ms of fn() over n runs, from CUDA events."""
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def profiled(name: str, fn, out_dir: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiler, one {name} step: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * dev_ms / wall_ms:.1f}%); top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:110]}")
    ops = [e for e in avg if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")]
    print("  top operators by device time (children included):")
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:110]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_train_{name}.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=100))
        f.write("\n\n")
        f.write(avg.table(sort_by="device_time_total", row_limit=100))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    B, cfg = args.batch, GeneratorConfig()
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution**2 / B)
    G = Ide3dGenerator(cfg).init(seed=0).cuda()
    D = Discriminator(DiscriminatorConfig(img_channels=gan.d_input_channels(tcfg, cfg))).init(1).cuda()
    state = gan.init_gan_state(G, D, tcfg)
    step = gan.make_gan_train_step(tcfg)
    batch = synthetic_batch(B, cfg.img_resolution, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one(r1: bool):
        state.step = 0 if r1 else 1
        step(state, batch, gen, ADA_P)

    for r1 in (True, False, True, False):  # warm-up
        one(r1)
    t_plain = timed(lambda: one(False), args.steps)
    t_r1 = timed(lambda: one(True), args.steps)
    print(f"train step, batch {B}: without R1 {t_plain:.3f} ms, with R1 {t_r1:.3f} ms "
          f"(median of {args.steps}, CUDA events)")

    # The parts, each as the step runs it (no optimizer step for D's parts).
    b = gan.expand_compact_batch(batch)
    d_in = functools.partial(gan.d_input, tcfg=tcfg, gen=gen, ada_p=ADA_P)
    fakes = gan.d_triple_fake(gan.synth_fake(G, torch.randn(B, 512, device="cuda"), b["c"], tcfg, gen))
    fakes = tuple(f.detach() for f in fakes)
    real = gan.d_triple_real(b["img"], b["seg"], cfg.render_size)
    params = list(D.parameters())

    def d_part():
        loss, _ = gan.d_loss(D, fakes, real, b["c"], d_in)
        torch.autograd.grad(loss, params)

    def r1_part():
        r1 = gan.r1_penalty(D, real, b["c"], d_in)
        torch.autograd.grad(r1, params, allow_unused=True)

    parts = {"D loss + grad": timed(d_part, args.steps), "R1 + grad": timed(r1_part, args.steps)}
    print("parts (median ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f"; the G phase is the step without R1 less the D loss")
    profiled("plain", lambda: one(False), args.out)
    profiled("r1", lambda: one(True), args.out)


if __name__ == "__main__":
    main()
