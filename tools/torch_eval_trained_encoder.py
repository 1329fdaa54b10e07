"""Batch reconstruction metrics for a trained G + hybrid encoder, with the
PyTorch port (counterpart of tools/eval_trained_encoder.py, same flags and
output, plus --device).

On the synthetic pose-consistent dataset (tools/torch_make_synthetic_dataset.py),
for N dataset views, rec_ws = E(img, seg) + w_avg, re-rendered at the view's
own camera, reports

  * rgb_l2   — mean per-pixel squared error,
  * seg_miou — mean IoU between the input 19-class mask and the re-rendered
               semantics (over the classes present in either mask),
  * ws_spread — std of the recovered latents across identities (collapse check).

Prints one JSON line. One G pass (one K1 launch) a batch; the ragged tail of
the N views is dropped, as the JAX tool does.

Usage:
    python tools/torch_eval_trained_encoder.py --network runs/gan/snapshot-final \\
        --encoder runs/enc/encoder-00006000 --data data/sphere --n 32 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_view(data: str, name: str, label) -> tuple:
    """(img float32 [R,R,3] in [-1,1], mask int64 [R,R], OpenGL label [25]) of
    one dataset view; the dataset's labels are OpenCV's."""
    import PIL.Image

    img = np.asarray(PIL.Image.open(os.path.join(data, "img", name)).convert("RGB"),
                     np.float32) / 127.5 - 1.0
    mask = np.asarray(PIL.Image.open(os.path.join(data, "seg", name)).convert("L"), np.int64)
    c = np.asarray(label, np.float32).copy()
    c[[1, 2, 5, 6, 9, 10]] *= -1  # OpenCV -> OpenGL
    return img, mask, c


def mean_iou(pred: np.ndarray, mask: np.ndarray) -> float:
    """mIoU over the classes present in either integer mask."""
    per_cls = []
    for cls in np.union1d(np.unique(mask), np.unique(pred)):
        p, t = pred == cls, mask == cls
        per_cls.append((p & t).sum() / max((p | t).sum(), 1))
    return float(np.mean(per_cls))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--encoder", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ide3d_tpu_torch.apps.common import load_generator
    from ide3d_tpu_torch.apps.infer_hybrid_encoder import build_encoder
    from ide3d_tpu_torch.utils.seg import mask2onehot

    device = torch.device(args.device)
    G = load_generator(args.network, device).requires_grad_(False)
    E = build_encoder(G, args.encoder, device)
    w_avg = G.mapping.w_avg[None, None, :]

    with open(os.path.join(args.data, "img", "dataset.json")) as f:
        labels = dict(json.load(f)["labels"])
    names = sorted(labels)[: args.n]

    l2s, ious, ws_all = [], [], []
    B = args.batch
    for i in range(0, len(names) - B + 1, B):  # the ragged tail is dropped
        views = [read_view(args.data, nm, labels[nm]) for nm in names[i: i + B]]
        imgs = np.stack([v[0] for v in views])
        masks = np.stack([v[1] for v in views])
        with torch.inference_mode():
            img_b = torch.from_numpy(imgs).to(device)
            seg_pm = mask2onehot(torch.from_numpy(masks).to(device)) * 2.0 - 1.0
            c = torch.from_numpy(np.stack([v[2] for v in views])).to(device)
            ws = E(img_b, seg_pm) + w_avg
            out, out_seg = G.synthesis(ws, c, return_seg=True)
            out = out.float().cpu().numpy()
            pred = out_seg.argmax(dim=-1).cpu().numpy()
            ws_all.append(ws.float().cpu().numpy())
        l2s.append(((out - imgs) ** 2).mean(axis=(1, 2, 3)))
        ious += [mean_iou(pred[b], masks[b]) for b in range(B)]

    ws_cat = np.concatenate(ws_all)
    print(json.dumps({
        "n": int(len(ious)),
        "rgb_l2": round(float(np.concatenate(l2s).mean()), 5),
        "seg_miou": round(float(np.mean(ious)), 4),
        "ws_spread": round(float(ws_cat.std(axis=0).mean()), 4),
    }))


if __name__ == "__main__":
    main()
