"""In-the-wild FFHQ preprocessing: detect -> recon pose -> crop -> dataset.json.

Counterpart of ide3d_tpu/apps/preprocess_in_the_wild.py, with the same
arguments and files (the reference's dataset_preprocessing/ffhq/
preprocess_in_the_wild.py):
  1. batch_mtcnn.py - MTCNN 5-landmark detection per image (biggest face,
     confidence > 0.9) -> detections/<name>.txt; an existing file is used as
     it is (the detections are cached),
  2. Deep3DFaceRecon test.py - 3DMM coefficients from the aligned 224² crop,
  3. 3dface2idr_mat.py + preprocess_cameras.py --mode orig - coefficients ->
     the 25-dim camera label,
  4. crop_images_in_the_wild.py - the POS-aligned 512² recrop -> crop/<name>.png,
     with crop/dataset.json ({"labels": [[name, label], ...]}).

The nets (models/mtcnn.py, models/face_recon.py) run on `--device` (the card
by default, the CPU only when asked); the weights are read without running
their pickles (io.load_torch_state_dict):

    python -m ide3d_tpu_torch.apps.preprocess_in_the_wild --indir photos/ \\
        --mtcnn mtcnn_weights/ --face-recon epoch_20.pth
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--indir", required=True)
    ap.add_argument("--mtcnn", required=True,
                    help="dir with pnet.pt / rnet.pt / onet.pt state dicts")
    ap.add_argument("--face-recon", required=True,
                    help="Deep3DFaceRecon checkpoint (epoch_20.pth)")
    ap.add_argument("--min-confidence", type=float, default=0.9)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from ..data.preprocess import align_crop
    from ..io.torch_import import load_torch_state_dict
    from ..models.face_recon import coeffs_to_pose_label, import_face_recon
    from ..models.mtcnn import MTCNN, import_mtcnn, write_detection

    device = torch.device(args.device)
    det_dir = os.path.join(args.indir, "detections")
    crop_dir = os.path.join(args.indir, "crop")
    os.makedirs(det_dir, exist_ok=True)
    os.makedirs(crop_dir, exist_ok=True)

    detector = MTCNN(import_mtcnn(
        *(load_torch_state_dict(os.path.join(args.mtcnn, f"{n}.pt")) for n in ("pnet", "rnet", "onet")),
        device=device))
    recon = import_face_recon(load_torch_state_dict(args.face_recon), device=device)

    imgs = sorted(f for f in os.listdir(args.indir) if f.lower().endswith((".jpg", ".png", ".jpeg")))
    labels = []
    for fname in imgs:
        img = np.asarray(PIL.Image.open(os.path.join(args.indir, fname)).convert("RGB"))
        base = fname.rsplit(".", 1)[0]
        det_path = os.path.join(det_dir, base + ".txt")

        # stage 1: detect (cached like batch_mtcnn.py:41)
        if not os.path.exists(det_path):
            if not write_detection(detector.detect_faces(img), det_path, args.min_confidence):
                print(f"{fname}: no confident face, skipped")
                continue
        lm = np.loadtxt(det_path).reshape(-1, 2)

        # stage 2+3: Deep3DFaceRecon alignment (224 @ rescale 102), coeffs, pose
        im224 = align_crop(img, lm, target_size=224.0, rescale_factor=102.0,
                           center_crop_size=224, output_size=224)
        with torch.no_grad():
            x = torch.tensor(im224[None], dtype=torch.float32, device=device) / 255.0
            coeffs = recon(x).cpu().numpy()
        label = coeffs_to_pose_label(coeffs)[0]

        # stage 4: the 512² training recrop
        crop = align_crop(img, lm)
        out_name = base + ".png"
        PIL.Image.fromarray(crop).save(os.path.join(crop_dir, out_name))
        labels.append([out_name, label.tolist()])
        print(f"{fname}: ok")

    with open(os.path.join(crop_dir, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    print(f"wrote {len(labels)} entries to {crop_dir}/dataset.json")


if __name__ == "__main__":
    main()
