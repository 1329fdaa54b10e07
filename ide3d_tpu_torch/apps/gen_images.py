"""Generate multi-view RGB images + semantic masks (the port's gen_images).

Usage:
    python -m ide3d_tpu_torch.apps.gen_images --network random:0 --seeds 0-3 --outdir out/

Same CLI as `python -m ide3d_tpu.apps.gen_images`. For each seed: one z -> w+
(with truncation), rendered at yaws {-0.5, 0, 0.5} as one batch of three;
RGB saved as seed{NNNN}.png and the colorized 19-class mask as
seed{NNNN}_seg.png, both 1x3 grids. Runs on the first CUDA device when there
is one, else on the CPU (`--device` overrides).
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional

import numpy as np
import torch

from ..render.camera import CANONICAL_POSE_25, look_at_pose, make_label_25
from ..render.renderer import RenderParams
from ..utils.seg import mask2color
from .common import load_generator, parse_range, save_image_grid

YAWS = (-0.5, 0.0, 0.5)


def yaw_cameras(device: torch.device | str = "cpu") -> torch.Tensor:
    """The three labels [3, 25] of the free-view sweep, radius 2.7, looking at the origin."""
    return torch.cat([
        make_label_25(look_at_pose(y + math.pi / 2, math.pi / 2, [0.0, 0.0, 0.0],
                                   radius=2.7, device=device))
        for y in YAWS
    ])


@torch.inference_mode()
def synth_views(
    G, ws: torch.Tensor, cams: torch.Tensor, rp: RenderParams,
    noise_mode: str = "const", generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One w+ [1, num_ws, w_dim] rendered at every camera of `cams` [V, 25] as one
    batch. Returns (img [V,R,R,3] in [-1,1], seg [V,R,R,19] scores, seg_rgb [V,R,R,3])."""
    ws_v = ws.expand(cams.shape[0], -1, -1)
    img, seg = G.synthesis(ws_v, cams, render_params=rp, noise_mode=noise_mode,
                           generator=generator, return_seg=True)
    return img, seg, mask2color(seg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True, help="random:<seed>[:tiny|small]")
    ap.add_argument("--seeds", required=True, help="e.g. 0,1,4-6")
    ap.add_argument("--trunc", type=float, default=1.0, dest="truncation_psi")
    ap.add_argument("--noise-mode", choices=["const", "random", "none"], default="const")
    ap.add_argument("--num-steps", type=int, default=96)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available() else "cpu")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    G = load_generator(args.network, dev)
    os.makedirs(args.outdir, exist_ok=True)
    rp = RenderParams(img_size=G.cfg.render_size, num_steps=args.num_steps, hierarchical=True)
    cs = torch.as_tensor(CANONICAL_POSE_25, device=dev)[None]
    cams = yaw_cameras(dev)

    for seed in parse_range(args.seeds):
        z = torch.as_tensor(np.random.RandomState(seed).randn(1, G.z_dim), dtype=torch.float32,
                            device=dev)
        gen = None
        if args.noise_mode == "random":
            gen = torch.Generator(device=dev).manual_seed(seed)
        with torch.inference_mode():
            ws = G.mapping(z, cs, truncation_psi=args.truncation_psi)
        img, _, seg_rgb = synth_views(G, ws, cams, rp, args.noise_mode, gen)
        save_image_grid(img.cpu().numpy(), f"{args.outdir}/seed{seed:04d}.png", grid=(3, 1))
        save_image_grid(seg_rgb.cpu().numpy() / 127.5 - 1.0,
                        f"{args.outdir}/seed{seed:04d}_seg.png", grid=(3, 1))
        print(f"seed {seed}: wrote {args.outdir}/seed{seed:04d}.png (+_seg)")


if __name__ == "__main__":
    main()
