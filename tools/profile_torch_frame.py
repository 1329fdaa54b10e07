"""Where the time of the port's free-view frame goes, on one CUDA card.

    python3 tools/profile_torch_frame.py [--frames 10] [--out out]

GeneratorConfig() with random weights (init(seed=0)), bf16, 96+96 samples.
Prints, each from CUDA events (median over --frames frames):
  * the frame at batch 1 and at the gen_images batch of 3 yaws, with K1 and
    with K1's plain version in its place, in turns (K1, plain, plain, K1),
  * the kernels by device time over 3 batch-3 frames (torch.profiler) and the
    device's busy share of that window; the full table goes to
    <out>/profile_frame.txt,
  * from the same profile, the device ms a frame of each of G's stages, the
    rows of its spans (utils/profiling.span): `G.planes` (vb stack, table),
    `G.render` (coarse and fine passes, K1), `G.finish` (raw head, superres,
    seg upsample).
Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ide3d_tpu_torch.apps import gen_images  # noqa: E402
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator  # noqa: E402
from ide3d_tpu_torch.ops import ray_march  # noqa: E402
from ide3d_tpu_torch.render import renderer  # noqa: E402
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25  # noqa: E402
from ide3d_tpu_torch.render.renderer import RenderParams  # noqa: E402

STAGES = ("G.planes", "G.render", "G.finish")


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    cfg = GeneratorConfig()
    G = Ide3dGenerator(cfg).init(seed=0).to("cuda").eval()
    with torch.inference_mode():
        run(G, cfg, args)


def run(G, cfg, args) -> None:
    rp = RenderParams(img_size=cfg.render_size, num_steps=96, hierarchical=True)
    cams3 = gen_images.yaw_cameras("cuda")
    cams1 = cams3[1:2]
    z = torch.as_tensor(np.random.RandomState(0).randn(1, cfg.z_dim), dtype=torch.float32, device="cuda")
    ws = G.mapping(z, torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None])
    for cams in (cams1, cams3):
        gen_images.synth_views(G, ws, cams, rp)

    def frame(cams):
        return lambda: gen_images.synth_views(G, ws, cams, rp)

    for name, cams in (("batch 1", cams1), ("batch 3", cams3)):
        res = {"K1": [], "plain": []}
        for which in ("K1", "plain", "plain", "K1"):
            renderer.sort_integrate = (ray_march.sort_integrate if which == "K1"
                                       else ray_march.sort_integrate_plain)
            res[which].append(timed(frame(cams), args.frames))
        renderer.sort_integrate = ray_march.sort_integrate
        print(f"frame {name}: K1 {res['K1']} ms, plain composite {res['plain']} ms "
              f"(median of {args.frames} each, in turns K1, plain, plain, K1)")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            gen_images.synth_views(G, ws, cams3, rp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    stage = {e.key: e.device_time_total / 1e3 / 3 for e in rows
             if e.key in STAGES and e.device_type == torch.autograd.DeviceType.CPU}
    print("stages batch 3 (device ms a frame, from the spans): " + ", ".join(
        f"{k} {stage.get(k, float('nan')):.3f}" for k in STAGES))
    events = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]  # a span's device row is no kernel
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiler, 3 batch-3 frames: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * dev_ms / wall_ms:.1f}%); top kernels by device time:")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:15]:
        print(f"  {e.self_device_time_total / 1e3 / 3:9.3f} ms/frame  x{math.ceil(e.count / 3):4d}  "
              f"{e.key[:100]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_frame.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))


if __name__ == "__main__":
    main()
