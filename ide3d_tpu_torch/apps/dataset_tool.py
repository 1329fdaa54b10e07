"""Dataset packaging tool: an image folder (+ a mask folder, + camera labels)
-> the zip layout that data/dataset.ImageFolderDataset reads.

Counterpart of ide3d_tpu/apps/dataset_tool.py, with the same flags and the
same zip entries: images at a fixed resolution as img%08d.png, dataset.json
with the 25-dim labels, masks (nearest-resized) in a second zip under the
same names; `--mirror` adds x-flipped copies with yaw-flipped labels and
left/right-swapped mask classes. Host-only (numpy and PIL):

    python -m ide3d_tpu_torch.apps.dataset_tool --source imgs/ --dest data.zip \
        [--masks masks/ --mask-dest segs.zip] [--resolution 512] [--labels poses.json] [--mirror]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zipfile


def main(argv=None):
    import numpy as np
    import PIL.Image

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True)
    ap.add_argument("--dest", required=True)
    ap.add_argument("--masks", default=None)
    ap.add_argument("--mask-dest", default=None)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--labels", default=None,
                    help="json {fname: 25-dim label}; default dataset.json in source")
    ap.add_argument("--mirror", action="store_true",
                    help="materialize x-flipped copies with yaw-flipped labels "
                         "(the reference's mirror_dataset step, "
                         "preprocess_face_cameras.py:101-107; pose math flip_yaw "
                         ":53-60 == our on-the-fly xflip relabel); mirrored masks "
                         "swap the left/right class pairs")
    args = ap.parse_args(argv)

    exts = {".png", ".jpg", ".jpeg", ".webp"}
    fnames = sorted(
        f for f in os.listdir(args.source) if os.path.splitext(f)[1].lower() in exts
    )
    assert fnames, f"no images in {args.source}"

    labels = None
    label_path = args.labels or os.path.join(args.source, "dataset.json")
    if os.path.exists(label_path):
        with open(label_path) as f:
            data = json.load(f)
        labels = dict(data["labels"]) if "labels" in data else data

    R = args.resolution
    n_out = 0
    out_labels = []
    with zipfile.ZipFile(args.dest, "w", zipfile.ZIP_STORED) as zf:
        for fname in fnames:
            img = PIL.Image.open(os.path.join(args.source, fname)).convert("RGB")
            if img.size != (R, R):
                img = img.resize((R, R), PIL.Image.LANCZOS)
            variants = [(img, False)]
            if args.mirror:
                variants.append((img.transpose(PIL.Image.FLIP_LEFT_RIGHT), True))
            for im, flipped in variants:
                arcname = f"img{n_out:08d}.png"
                n_out += 1
                buf = io.BytesIO()
                im.save(buf, "PNG")
                zf.writestr(arcname, buf.getvalue())
                if labels is not None and fname in labels:
                    lab = list(labels[fname])
                    if flipped:
                        # flip_yaw on the stored cam2world (flat idx 1,2,3,4,8;
                        # preprocess_face_cameras.py:53-60) — commutes with the
                        # loader's OpenCV->OpenGL sign flip
                        for j in (1, 2, 3, 4, 8):
                            lab[j] = -lab[j]
                    out_labels.append([arcname, lab])
        if out_labels:
            zf.writestr("dataset.json", json.dumps({"labels": out_labels}))
    print(f"wrote {args.dest}: {n_out} images" +
          (f", {len(out_labels)} labels" if out_labels else ""))

    if args.masks:
        dest = args.mask_dest or args.dest.replace(".zip", "_seg.zip")
        mask_names = sorted(
            f for f in os.listdir(args.masks) if os.path.splitext(f)[1].lower() in exts
        )
        # mirrored masks swap left/right classes (utils/seg.py CLASSES:
        # l_eye 4 <-> r_eye 5, l_brow 6 <-> r_brow 7, l_ear 8 <-> r_ear 9)
        lr_swap = np.arange(256, dtype=np.uint8)
        for a, b in ((4, 5), (6, 7), (8, 9)):
            lr_swap[a], lr_swap[b] = b, a
        n_out = 0
        with zipfile.ZipFile(dest, "w", zipfile.ZIP_STORED) as zf:
            for fname in mask_names:
                m = PIL.Image.open(os.path.join(args.masks, fname)).convert("L")
                if m.size != (R, R):
                    m = m.resize((R, R), PIL.Image.NEAREST)
                variants = [m]
                if args.mirror:
                    arr = np.asarray(m.transpose(PIL.Image.FLIP_LEFT_RIGHT))
                    variants.append(PIL.Image.fromarray(lr_swap[arr]))
                for mm in variants:
                    buf = io.BytesIO()
                    mm.save(buf, "PNG")
                    zf.writestr(f"img{n_out:08d}.png", buf.getvalue())
                    n_out += 1
        print(f"wrote {dest}: {n_out} masks")


if __name__ == "__main__":
    main()
