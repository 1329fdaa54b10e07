"""End-to-end inversion + editing demo on trained weights, with the PyTorch
port (counterpart of tools/painter_trained_demo.py, same flags and output,
plus --device).

Drives the IDE-3D product loop (the reference's Painter/run_UI.py:167-206)
against a generator trained by apps/train_gan.py and a hybrid encoder trained
by apps/train_hybrid_encoder.py on the synthetic pose-consistent dataset:

  1. invert a dataset view: rec_ws = E(img, seg) + w_avg, or load the pivot
     of run_pti (--pivot, the `ws` array of its .npz) with a tuned --network,
  2. reconstruct at the view's own camera and at the canonical front pose,
  3. apply a semantic mask edit (dilate the hair class) through
     PainterSession.edit — re-encode, appearance-locked,
  4. re-render the edited latent at yaws -0.4, 0, 0.4.

Writes under --outdir:
  <prefix>_recon.png      [target | recon@pose | recon@front]
  <prefix>_edit.png       [before | after @ yaw sweep]
  <prefix>_edit_mask.png  the colorized edited mask

Usage:
    python tools/torch_painter_trained_demo.py --network runs/gan/snapshot-final \\
        --encoder runs/enc/encoder-00006000 --data data/sphere --item 00000_2 \\
        --outdir out/ [--pivot out/pti/00000_2.npz] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dilate_hair(mask: np.ndarray, k: int) -> np.ndarray:
    """Grow the hair class (17) downward by k rows over skin (1)."""
    edited = mask.copy()
    hair = mask == 17
    grown = hair.copy()
    for dy in range(1, k + 1):
        grown[dy:, :] |= hair[:-dy, :]
    edited[grown & (mask == 1)] = 17
    return edited


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--encoder", required=True)
    ap.add_argument("--data", required=True, help="synthetic dataset root (img/ seg/)")
    ap.add_argument("--item", default="00000_2")
    ap.add_argument("--hair-dilate", type=int, default=5)
    ap.add_argument("--pivot", default=None,
                    help="npz ws from run_pti: use the PTI pivot latent (with a tuned "
                         "--network) instead of the encoder inversion")
    ap.add_argument("--prefix", default="painter_trained", help="output file prefix")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from ide3d_tpu_torch.apps.common import load_generator, save_image_grid
    from ide3d_tpu_torch.apps.infer_hybrid_encoder import build_encoder, load_image, load_mask
    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.utils.seg import mask2color, mask2onehot

    device = torch.device(args.device)
    G = load_generator(args.network, device).requires_grad_(False)
    E = build_encoder(G, args.encoder, device)
    R = G.cfg.img_resolution

    img = load_image(os.path.join(args.data, "img", args.item + ".png"), R)
    mask = load_mask(os.path.join(args.data, "seg", args.item + ".png"), R)
    with open(os.path.join(args.data, "img", "dataset.json")) as f:
        labels = dict(json.load(f)["labels"])
    c_own = np.asarray(labels[args.item + ".png"], np.float32).copy()
    c_own[[1, 2, 5, 6, 9, 10]] *= -1  # OpenCV -> OpenGL (dataset_seg.py:314)
    c_own = torch.from_numpy(c_own).to(device)[None]
    c_front = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]

    # 1) invert, or load a PTI pivot (run_pti output) when --pivot is given
    with torch.inference_mode():
        if args.pivot:
            rec_ws = torch.as_tensor(np.load(args.pivot)["ws"], device=device)
        else:
            seg_pm = mask2onehot(torch.from_numpy(mask).to(device)[None]) * 2.0 - 1.0
            rec_ws = E(torch.from_numpy(img).to(device)[None], seg_pm) + G.mapping.w_avg[None, None]
        recon_own = G.synthesis(rec_ws, c_own).float().cpu().numpy()
        recon_front = G.synthesis(rec_ws, c_front).float().cpu().numpy()

    os.makedirs(args.outdir, exist_ok=True)
    grid = np.stack([img, recon_own[0], recon_front[0]])
    save_image_grid(grid, os.path.join(args.outdir, args.prefix + "_recon.png"), grid=(3, 1))

    # 2) mask edit: dilate the hair class downward over skin, at the front view
    edited = dilate_hair(mask, args.hair_dilate)
    sess = PainterSession(G=G, E=E, device=device)
    sess.set_inversion(rec_ws)
    sess.edit(edited)  # updates sess.w (appearance-locked)
    sweep = [sess.view(yaw=yaw)[0].astype(np.float32) / 127.5 - 1.0 for yaw in (-0.4, 0.0, 0.4)]
    grid = np.stack([recon_front[0]] + sweep)
    save_image_grid(grid, os.path.join(args.outdir, args.prefix + "_edit.png"), grid=(4, 1))

    # colorized edited mask for the writeup
    mc = mask2color(mask2onehot(torch.from_numpy(edited)[None]) * 2.0 - 1.0)[0].numpy()
    PIL.Image.fromarray(mc.astype(np.uint8)).save(
        os.path.join(args.outdir, args.prefix + "_edit_mask.png"))
    print(f"wrote {args.outdir}/{args.prefix}_recon.png, {args.prefix}_edit.png")


if __name__ == "__main__":
    main()
