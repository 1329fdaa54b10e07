"""Hybrid-encoder inference: one image (+ mask) -> a w+ code and its render.

Counterpart of ide3d_tpu/apps/infer_hybrid_encoder.py: the image (and its
19-class mask, or BiSeNet's parse of the image with `--bisenet`), E(img, seg)
+ w_avg, an optional appearance override from another code, then G's render
and seg; writes rec_ws.npz, recon.png and recon_seg.png.

Usage:
    python -m ide3d_tpu_torch.apps.infer_hybrid_encoder --network <G snapshot|random:0> \\
        --encoder <E checkpoint|random:0> --img face.png [--mask mask.png | --bisenet segNet-20Class.pth] \\
        [--appearance-code other_ws.npz] --outdir out/ [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_image(path: str, resolution: int) -> np.ndarray:
    """RGB [R, R, 3] float32 in [-1, 1], resized with PIL's LANCZOS."""
    import PIL.Image

    img = PIL.Image.open(path).convert("RGB").resize((resolution, resolution), PIL.Image.LANCZOS)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def load_mask(path: str, resolution: int) -> np.ndarray:
    """Class ids [R, R] int64, resized with PIL's NEAREST."""
    import PIL.Image

    m = PIL.Image.open(path).convert("L").resize((resolution, resolution), PIL.Image.NEAREST)
    return np.asarray(m, np.int64)


def build_encoder(G, encoder: str, device):
    """The fp32 HybridEncoder at G's width: `random:<seed>` (seeded init) or a
    checkpoint directory (its "E" state dict, or the state itself)."""
    from ..io.checkpoint import load_checkpoint
    from ..models.encoder import HybridEncoder

    n_geo = G.synthesis.num_ws_geo
    E = HybridEncoder(size=G.cfg.img_resolution, n_latents_app=G.num_ws - n_geo,
                      n_latents_geo=n_geo, w_dim=G.cfg.w_dim, input_seg_dim=G.cfg.seg_channels)
    if encoder.startswith("random"):
        E.init(int(encoder.split(":")[1]) if ":" in encoder else 0)
    else:
        state, _ = load_checkpoint(encoder)
        E.load_state_dict(state["E"] if "E" in state else state)
    return E.to(device).eval().requires_grad_(False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--encoder", default="random:0")
    ap.add_argument("--img", required=True)
    ap.add_argument("--mask", default=None)
    ap.add_argument("--bisenet", default=None, help="segNet-20Class.pth for auto-parsing")
    ap.add_argument("--appearance-code", default=None,
                    help="npz ws whose appearance rows override the encoder's")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..render.camera import CANONICAL_POSE_25
    from ..utils.seg import id_remap, mask2color, mask2onehot
    from .common import load_generator, save_image_grid

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    R, n_geo = G.cfg.img_resolution, G.synthesis.num_ws_geo
    E = build_encoder(G, args.encoder, device)

    with torch.no_grad():
        img = torch.as_tensor(load_image(args.img, R), device=device)[None]
        if args.mask is not None:
            seg = mask2onehot(torch.as_tensor(load_mask(args.mask, R), device=device)[None]) * 2.0 - 1.0
        else:
            if not args.bisenet:
                raise SystemExit("provide --mask or --bisenet weights")
            from ..io.torch_import import import_bisenet

            bis = import_bisenet(args.bisenet, device=device)
            seg = mask2onehot(id_remap(bis(img).argmax(dim=-1))) * 2.0 - 1.0
        rec_ws = E(img, seg) + G.mapping.w_avg[None, None]
        if args.appearance_code:
            other = torch.as_tensor(np.load(args.appearance_code)["ws"], device=device)
            rec_ws = torch.cat([rec_ws[:, :n_geo], other[:, n_geo:]], dim=1)
        c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]
        recon, recon_seg = G.synthesis(rec_ws, c, return_seg=True)

    os.makedirs(args.outdir, exist_ok=True)
    np.savez(os.path.join(args.outdir, "rec_ws.npz"), ws=rec_ws.cpu().numpy())
    save_image_grid(recon.cpu().numpy(), os.path.join(args.outdir, "recon.png"))
    save_image_grid(mask2color(recon_seg).cpu().numpy() / 127.5 - 1.0,
                    os.path.join(args.outdir, "recon_seg.png"))
    print(f"wrote {args.outdir}/rec_ws.npz, recon.png, recon_seg.png")


if __name__ == "__main__":
    main()
