"""Procedural multi-view "sphere-head" dataset for training-dynamics validation,
written with the PyTorch port's camera (ide3d_tpu_torch.render.camera) and
numpy only, so that it runs where JAX is not installed. It writes what
tools/make_synthetic_dataset.py writes, with the same command line.

Zero-egress environments have no FFHQ, so this tool ray-traces a pose-consistent
synthetic stand-in with the package's EXACT camera conventions (render/camera:
look_at_pose, get_initial_rays, fov 18, radius 2.7, OpenCV-stored labels like
training/dataset_seg.py:314 expects): per identity, a Lambertian sphere "head"
with semantic regions — skin, eyes, nose, mouth, hair — rendered from cameras
drawn from an FFHQ-like pose distribution, plus the matching 19-class masks and
dataset.json. A GAN trained on this must learn real pose-conditioned 3D
structure (the views are geometrically consistent), which exercises the
training loop far beyond isfinite checks.

    python tools/torch_make_synthetic_dataset.py --out /tmp/sphere_faces \
        --identities 200 --views 4 --resolution 64
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CelebAMask 19-class ids (utils/seg.py): 0 bg, 1 skin, 4/5 eyes, 10 nose,
# 11 mouth, 17 hair.
BG, SKIN, L_EYE, R_EYE, NOSE, MOUTH, HAIR = 0, 1, 4, 5, 10, 11, 17


def _identity_params(rng: np.random.RandomState) -> dict:
    return {
        "radius": rng.uniform(0.24, 0.34),
        "skin": np.array([0.8, 0.6, 0.5]) + rng.uniform(-0.15, 0.15, 3),
        "hair": rng.uniform(0.05, 0.6, 3),
        "bg": rng.uniform(0.1, 0.9, 3),
        "hair_cut": rng.uniform(0.35, 0.6),      # y-cap
        "back": rng.uniform(-0.35, -0.1),        # z threshold for back-of-head hair
        "eye_sep": rng.uniform(0.3, 0.5),        # radians off +z around y
        "eye_h": rng.uniform(0.1, 0.25),         # eye elevation
        "eye_r": rng.uniform(0.08, 0.14),        # angular radius
        "mouth_y": rng.uniform(-0.45, -0.3),
        "mouth_w": rng.uniform(0.25, 0.45),
        "nose_r": rng.uniform(0.1, 0.16),
    }


def render_view(p: dict, cam2world: np.ndarray, res: int):
    """Trace one view. Returns (img uint8 [res,res,3], seg uint8 [res,res])."""
    from ide3d_tpu_torch.render.camera import get_initial_rays

    _, _, rays_d_cam = get_initial_rays(1, 2, (res, res), fov=18.0,
                                        ray_start=2.25, ray_end=3.3)
    d = rays_d_cam[0].numpy().astype(np.float64)         # [res², 3]
    R, t = cam2world[:3, :3], cam2world[:3, 3]
    d = d @ R.T                                          # world dirs
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = t[None]

    # sphere |o + s d| = r
    r = p["radius"]
    b = 2.0 * (d @ o[0])
    c = float(o[0] @ o[0]) - r * r
    disc = b * b - 4 * c
    hit = disc > 0
    s = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    pt = o + s[:, None] * d
    n = pt / r                                           # unit normal = direction

    ux, uy, uz = n[:, 0], n[:, 1], n[:, 2]
    seg = np.full(res * res, BG, np.uint8)
    col = np.tile(p["bg"][None], (res * res, 1))

    def ang(e):
        e = np.asarray(e, np.float64)
        e /= np.linalg.norm(e)
        return np.arccos(np.clip(n @ e, -1, 1))

    skin_m = hit
    hair_m = hit & ((uy > p["hair_cut"]) | (uz < p["back"]))
    le = hit & (ang([-np.sin(p["eye_sep"]), p["eye_h"], np.cos(p["eye_sep"])]) < p["eye_r"])
    re = hit & (ang([np.sin(p["eye_sep"]), p["eye_h"], np.cos(p["eye_sep"])]) < p["eye_r"])
    nose_m = hit & (ang([0.0, -0.08, 1.0]) < p["nose_r"])
    mouth_m = (hit & (np.abs(uy - p["mouth_y"]) < 0.08)
               & (uz > 0.55) & (np.abs(ux) < p["mouth_w"]))

    base = np.tile(p["skin"][None], (res * res, 1))
    base[hair_m] = p["hair"]
    base[nose_m & ~hair_m] = p["skin"] * 0.85
    base[mouth_m & ~hair_m] = [0.7, 0.25, 0.25]
    base[(le | re) & ~hair_m] = [0.15, 0.15, 0.35]

    seg[skin_m] = SKIN
    seg[hair_m] = HAIR
    seg[nose_m & ~hair_m] = NOSE
    seg[mouth_m & ~hair_m] = MOUTH
    seg[le & ~hair_m] = L_EYE
    seg[re & ~hair_m] = R_EYE

    light = np.array([0.3, 0.5, 0.8])
    light = light / np.linalg.norm(light)
    lam = np.clip(n @ light, 0, 1) * 0.7 + 0.3
    col = np.where(hit[:, None], base * lam[:, None], col)

    img = np.clip(col * 255, 0, 255).astype(np.uint8).reshape(res, res, 3)
    return img, seg.reshape(res, res)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--identities", type=int, default=200)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import PIL.Image
    import torch

    from ide3d_tpu_torch.render.camera import look_at_pose, make_label_25

    img_dir = os.path.join(args.out, "img")
    seg_dir = os.path.join(args.out, "seg")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)

    rng = np.random.RandomState(args.seed)
    labels = []
    for i in range(args.identities):
        p = _identity_params(rng)
        for v in range(args.views):
            # FFHQ-ish pose spread around the front (h = v = pi/2)
            h = np.pi / 2 + rng.randn() * 0.35
            vv = np.clip(np.pi / 2 + rng.randn() * 0.12, 0.3, np.pi - 0.3)
            c2w = look_at_pose(h, vv, [0.0, 0.0, 0.0], radius=2.7)[0].numpy().astype(
                np.float64)  # look_at_pose returns [B,4,4]
            img, seg = render_view(p, c2w, args.resolution)

            name = f"{i:05d}_{v}.png"
            PIL.Image.fromarray(img).save(os.path.join(img_dir, name))
            PIL.Image.fromarray(seg, mode="L").save(os.path.join(seg_dir, name))

            label = make_label_25(torch.from_numpy(c2w[None])).numpy().astype(
                np.float64).reshape(-1).copy()
            # store in OpenCV convention: the loader flips [1,2,5,6,9,10] back
            # (data/dataset.py:150, contract dataset_seg.py:314)
            label[[1, 2, 5, 6, 9, 10]] *= -1
            labels.append([name, label.tolist()])
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{args.identities} identities")

    with open(os.path.join(img_dir, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    print(f"wrote {len(labels)} views to {args.out} (img/ + seg/ + dataset.json)")


if __name__ == "__main__":
    main()
