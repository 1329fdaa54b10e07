"""Extract and show a generator's geometry (the port's render_mesh).

Usage:
    python -m ide3d_tpu_torch.apps.render_mesh --network random:0 --seed 0 \
        --voxel-resolution 128 --outdir meshes/ [--video orbit.mp4]

Same CLI as `python -m ide3d_tpu.apps.render_mesh`, plus `--device` (the CUDA
card unless asked otherwise): the sigma grid of one seed (extract_shapes'
sampling, in chunks of 2^17 points), marching tetrahedra at `--level` (the
98th percentile of sigma when the level lies outside its range) to {seed}.obj
and {seed}.ply, and with `--video` an orbit of normal-shaded depth rendered
from the fp32 planes by the renderer at 64 + 64 samples (one K1 launch a
frame); the shading runs on the host. `main` returns {"verts", "faces",
"level", "video", "ms_per_frame"}.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from ..render.camera import look_at_pose
from ..render.renderer import RenderParams


def shade_depth(d: np.ndarray, wsum: np.ndarray) -> np.ndarray:
    """Depth [h, w] and weights sum [h, w] -> uint8 [h, w, 3]: normals from the
    depth gradient lit from (0.3, 0.3, 0.9), black where the ray is empty."""
    mask = wsum > 0.5
    gy, gx = np.gradient(d)
    n = np.stack([-gx, -gy, np.ones_like(d) * 0.02], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8
    shade = np.clip(n @ np.array([0.3, 0.3, 0.9]), 0, 1) * mask
    return (np.repeat(shade[..., None], 3, -1) * 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True, help="random:<seed>[:preset] or a snapshot dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trunc", type=float, default=0.7)
    ap.add_argument("--voxel-resolution", type=int, default=128)
    ap.add_argument("--cube-size", type=float, default=0.3)
    ap.add_argument("--level", type=float, default=10.0, help="sigma iso level")
    ap.add_argument("--video", default=None)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils.marching import marching_tetrahedra, save_obj, save_ply
    from .common import load_generator, write_video
    from .extract_shapes import create_samples, fp32_table, seed_ws, sigma_grid

    dev = torch.device(args.device)
    G = load_generator(args.network, dev)
    S = G.synthesis
    os.makedirs(args.outdir, exist_ok=True)
    table = fp32_table(G, seed_ws(G, args.seed, args.trunc, dev))  # built once, fp32

    N = args.voxel_resolution
    samples = 0.9 * create_samples(N, args.cube_size)
    sig = sigma_grid(S.renderer, table, samples, 2**17).cpu().numpy().reshape(N, N, N)
    print(f"sigma range [{sig.min():.2f}, {sig.max():.2f}]")
    level = args.level
    if not (sig.min() < level < sig.max()):
        level = float(np.percentile(sig, 98))
        print(f"requested iso level {args.level} outside sigma range; using "
              f"98th percentile {level:.2f}")
    verts, faces = marching_tetrahedra(sig, level=level)
    print(f"mesh: {len(verts)} verts, {len(faces)} faces")
    save_obj(os.path.join(args.outdir, f"{args.seed}.obj"), verts, faces)
    save_ply(os.path.join(args.outdir, f"{args.seed}.ply"), verts, faces)

    out = {"verts": len(verts), "faces": len(faces), "level": level, "video": None,
           "ms_per_frame": None}
    if args.video:
        rp = RenderParams(img_size=G.cfg.render_size, num_steps=64, hierarchical=True)
        frames = []
        t0 = time.perf_counter()
        with torch.inference_mode():
            for i in range(args.frames):
                yaw = math.pi / 2 + 0.6 * math.sin(2 * math.pi * i / args.frames)
                c2w = look_at_pose(yaw, math.pi / 2, [0.0, 0.0, 0.0], radius=2.7, device=dev)
                r = S.renderer.render_fine(
                    S.renderer.render_coarse(None, None, c2w, rp, table=table), rp)
                d = r["depth"][0, ..., 0].cpu().numpy()
                frames.append(shade_depth(d, r["weights_sum"][0, ..., 0].cpu().numpy()))
        out["ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / max(1, args.frames)
        out["video"] = write_video(args.video, frames, fps=24)
        print(f"wrote {out['video']}")
    return out


if __name__ == "__main__":
    main()
