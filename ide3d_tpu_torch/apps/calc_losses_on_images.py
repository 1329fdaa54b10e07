"""Pairwise reconstruction metrics between two image folders (counterpart of
ide3d_tpu/apps/calc_losses_on_images.py).

Modes: l2 (mean squared difference in [-1, 1]), lpips (the port's LPIPS),
id (ArcFace cosine similarity of the embedded faces), miou (the masks' mean
IoU over the 19 classes present). Prints one JSON line {mode: {mean, std}}
and returns it; `--output` writes it too.

Usage:
    python -m ide3d_tpu_torch.apps.calc_losses_on_images --mode l2,lpips,id \\
        --data-a recon_dir/ --data-b gt_dir/ [--masks-a a/ --masks-b b/] \\
        [--lpips-weights lpips.pth] [--arcface-weights model_ir_se50.pth] [--device cuda]

Without --lpips-weights the LPIPS is uncalibrated (the JAX package's VGG16
init and random lin weights); without --arcface-weights ArcFace takes the JAX
package's random init. Runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def _files(d):
    return sorted(sum((glob.glob(os.path.join(d, e)) for e in ("*.png", "*.jpg")), []))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="l2,lpips")
    ap.add_argument("--data-a", required=True)
    ap.add_argument("--data-b", required=True)
    ap.add_argument("--masks-a", default=None)
    ap.add_argument("--masks-b", default=None)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--lpips-weights", default=None)
    ap.add_argument("--arcface-weights", default=None)
    ap.add_argument("--output", default=None, help="also write the JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .infer_hybrid_encoder import load_image, load_mask

    device = torch.device(args.device)
    fa, fb = _files(args.data_a), _files(args.data_b)
    if len(fa) != len(fb) or not fa:
        raise SystemExit(f"folder mismatch: {len(fa)} vs {len(fb)}")
    modes = args.mode.split(",")
    if "miou" in modes and not (args.masks_a and args.masks_b):
        raise SystemExit("mIoU needs --masks-a/--masks-b")

    lp = arc = None
    if "lpips" in modes:
        from ..metrics.lpips import LPIPS

        lp = LPIPS()
        if args.lpips_weights:
            from ..metrics.features import load_state_dict_file

            load_state_dict_file(lp, args.lpips_weights, prefixes=("vgg.features.", "lin"))
        else:
            lp.init()
            print("WARNING: uncalibrated LPIPS (random lin weights)")
        lp = lp.to(device).eval()
    if "id" in modes:
        from ..models.arcface import ArcFaceIRSE50

        arc = ArcFaceIRSE50()
        if args.arcface_weights:
            from ..metrics.features import load_state_dict_file

            load_state_dict_file(arc, args.arcface_weights)
        else:
            arc.init()
            print("WARNING: random ArcFace weights - ID numbers not meaningful")
        arc = arc.to(device).eval()

    scores = {m: [] for m in modes}
    with torch.no_grad():
        for pa, pb in zip(fa, fb):
            a = torch.as_tensor(load_image(pa, args.resolution), device=device)[None]
            b = torch.as_tensor(load_image(pb, args.resolution), device=device)[None]
            if "l2" in modes:
                scores["l2"].append(float((a - b).square().mean()))
            if "lpips" in modes:
                scores["lpips"].append(float(lp.mean(a, b)))
            if "id" in modes:
                ea, eb = arc.embed_faces(a), arc.embed_faces(b)
                ea = ea / torch.linalg.vector_norm(ea, dim=-1, keepdim=True)
                eb = eb / torch.linalg.vector_norm(eb, dim=-1, keepdim=True)
                scores["id"].append(float((ea * eb).sum()))
            if "miou" in modes:
                ma = load_mask(os.path.join(args.masks_a, os.path.basename(pa)), args.resolution)
                mb = load_mask(os.path.join(args.masks_b, os.path.basename(pb)), args.resolution)
                ious = []
                for cls in range(19):
                    union = np.logical_or(ma == cls, mb == cls).sum()
                    if union > 0:
                        ious.append(np.logical_and(ma == cls, mb == cls).sum() / union)
                scores["miou"].append(float(np.mean(ious)))

    result = {m: {"mean": float(np.mean(v)), "std": float(np.std(v))} for m, v in scores.items() if v}
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
