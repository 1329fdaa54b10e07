"""Where the time of the port's projector and PTI steps goes, on one CUDA card.

    python3 tools/profile_torch_inversion.py [--steps 6] [--out out]

GeneratorConfig() from init(seed=0), bf16, 96+96 samples, batch 1; the target
is its render at a known w + 0.3 N(0, 1), as chip_smoke.py phase 10 makes it.
After a warm-up run of each loop, prints:
  * the projector's noise machinery alone (the noise regularization of the 15
    buffers, its gradient and the renormalization), CUDA-event median,
  * for project_w_plus and pivotal_tune each over --steps steps under
    torch.profiler: the host ms a step, the device's busy ms a step and share,
    the top kernels and operators by device time.
The full tables go to <out>/profile_inversion_{projector,pti}.txt. Needs
CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator  # noqa: E402
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25  # noqa: E402
from ide3d_tpu_torch.train import pti  # noqa: E402


def profiled(name: str, fn, steps: int, out_dir: str, prefix: str = "inversion") -> None:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]  # a span's device row is no kernel
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{name}, {steps} steps under the profiler: {wall_ms / steps:.3f} ms a step on the host "
          f"clock, device busy {dev_ms / steps:.3f} ms a step ({100 * dev_ms / wall_ms:.1f}%), "
          f"{sum(e.count for e in kernels) / steps:.0f} kernels a step; top kernels by device time "
          f"(all steps):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:110]}")
    ops = [e for e in avg if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("aten::")]
    print("  top operators by device time (children included):")
    for e in sorted(ops, key=lambda e: -e.device_time_total)[:12]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:110]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{prefix}_{name}.txt"), "w") as f:
        f.write(avg.table(sort_by="self_device_time_total", row_limit=100))
        f.write("\n\n")
        f.write(avg.table(sort_by="device_time_total", row_limit=100))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_inversion: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    G = Ide3dGenerator(GeneratorConfig()).init(seed=0).cuda().eval()
    c = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    rs = np.random.RandomState(100)
    with torch.no_grad():
        w = G.mapping(torch.as_tensor(rs.randn(1, G.z_dim), dtype=torch.float32, device="cuda"), c)
        w = w + 0.3 * torch.as_tensor(rs.randn(1, G.num_ws, G.w_dim), dtype=torch.float32,
                                      device="cuda")
        target = G.synthesis(w, c).float().clamp(-1, 1)

    # The projector's noise machinery alone: regularization, its gradient, renormalization.
    params = dict(G.synthesis.named_parameters())
    noise = {k: torch.randn(params[k].shape, device="cuda").requires_grad_(True)
             for k in pti.noise_buffer_paths(G.synthesis)}

    def machinery():
        with torch.enable_grad():
            torch.autograd.grad(pti.noise_regularization(noise), list(noise.values()))
        pti.normalize_noise({k: v.detach() for k, v in noise.items()})

    times = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        machinery()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    print(f"noise machinery of {len(noise)} buffers (regularization + gradient + renormalization): "
          f"{statistics.median(times[1:]):.3f} ms (CUDA events, median)")

    n = args.steps
    cfg = pti.ProjectorConfig(num_steps=n)

    def project():
        return pti.project_w_plus(G, target, c, cfg, generator=torch.Generator(device="cuda").manual_seed(0))

    w_pivot = project()  # warm-up
    profiled("projector", project, n, args.out)
    tcfg = pti.PtiConfig(max_steps=n, lpips_threshold=-1.0)

    def tune():
        pti.pivotal_tune(G, w_pivot, target, c, tcfg)

    tune()  # warm-up
    profiled("pti", tune, n, args.out)


if __name__ == "__main__":
    main()
