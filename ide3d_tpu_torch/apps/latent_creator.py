"""Batch latent creation: a folder of images -> w+ codes (counterpart of
ide3d_tpu/apps/latent_creator.py).

One `<name>.npz` per image (keys `ws`, `c`) and an `index.json` of
[image, npz] pairs. The codes come from the w+ projector (with the hybrid
encoder's warm start given `--encoder` and `--masks`), or one-shot from an
e4e/pSp checkpoint with `--e4e` (no optimization).

Usage:
    python -m ide3d_tpu_torch.apps.latent_creator --network random:0 --images faces/ \\
        --steps 200 [--encoder ckpt --masks masks/ | --e4e e4e.pt] --outdir latents/ [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU. Image i's projector
draws come from a torch.Generator seeded i.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--masks", default=None)
    ap.add_argument("--encoder", default=None)
    ap.add_argument("--e4e", default=None,
                    help="e4e/pSp .pt checkpoint: one-shot e4e latents (no projector)")
    ap.add_argument("--e4e-variant", default="auto", choices=("auto", "e4e", "gradual"))
    ap.add_argument("--steps", type=int, default=450)
    ap.add_argument("--labels", default=None)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..render.camera import CANONICAL_POSE_25
    from ..train.pti import ProjectorConfig, project_w_plus
    from ..utils.seg import mask2onehot
    from .common import load_generator
    from .infer_hybrid_encoder import build_encoder, load_image, load_mask

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    R = G.cfg.img_resolution
    os.makedirs(args.outdir, exist_ok=True)
    files = sorted(sum((glob.glob(os.path.join(args.images, e)) for e in ("*.png", "*.jpg", "*.jpeg")), []))
    if not files:
        raise SystemExit(f"no images in {args.images}")

    labels = {}
    if args.labels:
        with open(args.labels) as f:
            labels = dict(json.load(f))

    e4e_fn = None
    if args.e4e:
        from .common import make_e4e_pivot_fn

        e4e_fn, e4e_report = make_e4e_pivot_fn(G, args.e4e, args.e4e_variant, device)
        print(f"e4e: {e4e_report}")
    E = build_encoder(G, args.encoder, device) if args.encoder else None

    index = []
    for i, f in enumerate(files):
        name = os.path.splitext(os.path.basename(f))[0]
        target = torch.as_tensor(load_image(f, R), device=device)[None]
        c = torch.as_tensor(np.asarray(labels.get(os.path.basename(f), CANONICAL_POSE_25),
                                       np.float32), device=device).reshape(1, 25)
        if e4e_fn is not None:
            ws, how = e4e_fn(target), " (e4e one-shot)"
        else:
            initial_w = None
            mask_path = os.path.join(args.masks, os.path.basename(f)) if args.masks else None
            if E is not None and mask_path and os.path.exists(mask_path):
                with torch.no_grad():
                    mask = torch.as_tensor(load_mask(mask_path, R), device=device)[None]
                    initial_w = E(target, mask2onehot(mask) * 2 - 1) + G.mapping.w_avg[None, None]
            ws = project_w_plus(G, target, c, ProjectorConfig(num_steps=args.steps),
                                initial_w=initial_w,
                                generator=torch.Generator(device=device).manual_seed(i))
            how = ""
        np.savez(os.path.join(args.outdir, f"{name}.npz"), ws=ws.cpu().numpy(), c=c.cpu().numpy())
        index.append([os.path.basename(f), f"{name}.npz"])
        print(f"[{i + 1}/{len(files)}] {name}{how}")

    with open(os.path.join(args.outdir, "index.json"), "w") as f:
        json.dump(index, f, indent=2)
    print(f"wrote {len(index)} latents to {args.outdir}")


if __name__ == "__main__":
    main()
