"""Semantic-driven face reenactment (counterpart of
ide3d_tpu/apps/infer_face_animation.py; the reference's
apps/infer_face_animation.py:92-155): a fixed style latent and one driving
19-class mask a frame -> E(style render, driving seg), the appearance rows
locked to the style's, rendered at the frame's pose (`--orbit` sweeps yaw).

Each frame is a PainterSession edit from the style latent (re-anchored every
frame, reference :144-152): an uncached edit, two G passes and one E pass.

    python -m ide3d_tpu_torch.apps.infer_face_animation --network random:0 \\
        --encoder random:0 --masks masks_dir/ --seed 7 --output anim.mp4 [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import math
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--encoder", default="random:0")
    ap.add_argument("--masks", required=True, help="directory of driving 19-class masks")
    ap.add_argument("--seed", type=int, default=0, help="style seed")
    ap.add_argument("--trunc", type=float, default=0.7)
    ap.add_argument("--orbit", action="store_true", help="sweep yaw while animating")
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .common import load_generator, write_video
    from .infer_hybrid_encoder import build_encoder, load_mask
    from .painter import PainterSession

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    R = G.cfg.img_resolution
    sess = PainterSession(G=G, E=build_encoder(G, args.encoder, device), device=device)
    sess.set_seed(args.seed, truncation_psi=args.trunc)
    sess.inversion = True  # lock the style's appearance rows across frames

    mask_files = sorted(glob.glob(os.path.join(args.masks, "*.png"))
                        + glob.glob(os.path.join(args.masks, "*.jpg")))
    if not mask_files:
        raise SystemExit(f"no masks in {args.masks}")

    frames = []
    style_w = sess.w
    for i, mf in enumerate(mask_files):
        mask = load_mask(mf, R)
        yaw = 0.35 * math.sin(2 * math.pi * i / len(mask_files)) if args.orbit else 0.0
        sess.w = style_w  # re-anchor the appearance every frame (reference :144-152)
        img, seg = sess.edit(mask, yaw=yaw)
        frames.append(np.concatenate([img, seg], axis=1))
        if i % 10 == 0:
            print(f"frame {i}/{len(mask_files)}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    out_path = write_video(args.output, frames, fps=args.fps)
    print(f"wrote {out_path} ({len(frames)} frames)")
    return out_path


if __name__ == "__main__":
    main()
