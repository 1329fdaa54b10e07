"""Avatar style transfer with a camera sweep (counterpart of
ide3d_tpu/apps/infer_face_animation_avatar.py; the reference's
apps/infer_face_animation_avatar.py:39-190): a fixed driving geometry (the
geometry rows of a seed's w+) restyled from a style source, rendered while
the camera sweeps yaw and pitch around the frontal pose.

The style source is `--style-image` through `G.encode` when G has the
built-in encoder (GeneratorConfig.use_encoder); otherwise, as in the JAX CLI,
the appearance rows of `--style-seed`'s w+ (style mixing). One G.synthesis
pass a frame.

    python -m ide3d_tpu_torch.apps.infer_face_animation_avatar --network random:0 \\
        --seed 1 --style-seed 7 --frames 48 --output avatar.mp4 [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--seed", type=int, default=0, help="driving geometry seed")
    ap.add_argument("--style-seed", type=int, default=7)
    ap.add_argument("--style-image", default=None,
                    help="restyle from an image via G.encode (needs a use_encoder G)")
    ap.add_argument("--trunc", type=float, default=0.7)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--yaw-range", type=float, default=0.45)
    ap.add_argument("--pitch-range", type=float, default=0.12)
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..render.camera import CANONICAL_POSE_25, look_at_pose, make_label_25
    from .common import load_generator, write_video

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    c0 = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]
    n_geo = G.synthesis.num_ws_geo

    def map_seed(seed):
        z = torch.as_tensor(np.random.RandomState(seed).randn(1, G.cfg.z_dim), dtype=torch.float32,
                            device=device)
        return G.mapping(z, c0, truncation_psi=args.trunc)

    frames = []
    with torch.inference_mode():
        ws_drive = map_seed(args.seed)
        if args.style_image and G.cfg.use_encoder:
            from .infer_hybrid_encoder import load_image

            img = torch.from_numpy(load_image(args.style_image, G.cfg.img_resolution))[None]
            ws_style, _ = G.encode(img.to(device))
        else:
            # No encoder: the appearance rows of a second seed (style mixing).
            ws_style = map_seed(args.style_seed)
        ws = torch.cat([ws_drive[:, :n_geo], ws_style[:, n_geo:]], dim=1)

        for i in range(args.frames):
            t = 2 * math.pi * i / args.frames
            yaw = args.yaw_range * math.sin(t)
            pitch = args.pitch_range * math.cos(t)
            c2w = look_at_pose(math.pi / 2 + yaw, math.pi / 2 + pitch, [0.0, 0.0, 0.0],
                               radius=2.7, device=device)
            img = G.synthesis(ws, make_label_25(c2w))[0]
            frames.append(((img + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy())
            if i % 12 == 0:
                print(f"frame {i}/{args.frames}")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    out = write_video(args.output, frames, fps=args.fps)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
