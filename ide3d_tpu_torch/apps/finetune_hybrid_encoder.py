"""Per-image encoder finetuning toward a pivot code (counterpart of
ide3d_tpu/apps/finetune_hybrid_encoder.py).

For one image and its mask: 50 x smooth-L1(E(img, seg) + w_avg, target code)
+ L2 of G's render of that code against the image + the cycle smooth-L1 of
the code re-encoded from tanh(the render's seg); Adam on E. Writes the
finetuned E as `finetuned_encoder` (io/checkpoint, its state dict under "E").

Usage:
    python -m ide3d_tpu_torch.apps.finetune_hybrid_encoder --network random:0 \\
        --encoder random:0 --img face.png --mask mask.png \\
        --target-code pivots/0.npz --steps 100 --outdir out/ [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--encoder", default="random:0")
    ap.add_argument("--img", required=True)
    ap.add_argument("--mask", required=True)
    ap.add_argument("--target-code", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..io.checkpoint import save_checkpoint
    from ..render.camera import CANONICAL_POSE_25
    from ..train import losses as L
    from ..utils.seg import mask2onehot
    from .common import load_generator
    from .infer_hybrid_encoder import build_encoder, load_image, load_mask

    device = torch.device(args.device)
    G = load_generator(args.network, device).requires_grad_(False)
    R = G.cfg.img_resolution
    E = build_encoder(G, args.encoder, device).requires_grad_(True)
    img = torch.as_tensor(load_image(args.img, R), device=device)[None]
    seg = mask2onehot(torch.as_tensor(load_mask(args.mask, R), device=device)[None]) * 2.0 - 1.0
    target_ws = torch.as_tensor(np.load(args.target_code)["ws"], device=device)
    c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]
    w_avg = G.mapping.w_avg[None, None]
    opt = torch.optim.Adam(E.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    with torch.enable_grad():
        for i in range(args.steps):
            rec_ws = E(img, seg) + w_avg
            l_ws = L.smooth_l1(rec_ws, target_ws) * 50.0
            rec_img, rec_seg = G.synthesis(rec_ws, c, return_seg=True)
            l_img = L.l2(rec_img, img)
            cyc_ws = E(img, torch.tanh(rec_seg)) + w_avg
            l_cyc = L.smooth_l1(rec_ws.detach(), cyc_ws)
            loss = l_ws + l_img + l_cyc
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if i % 20 == 0:
                print(f"step {i}: loss {float(loss.detach()):.4f}")

    os.makedirs(args.outdir, exist_ok=True)
    save_checkpoint(os.path.join(args.outdir, "finetuned_encoder"), {"E": E.state_dict()})
    print(f"wrote {args.outdir}/finetuned_encoder")


if __name__ == "__main__":
    main()
