"""FFHQ camera-pose preprocessing: Deep3DFaceRecon output -> 25-dim labels,
and the POS-aligned in-the-wild crop.

The port's own copy of ide3d_tpu/data/preprocess.py (numpy, scipy and PIL
only; the port imports nothing of the JAX package). Reference pipeline
(dataset_preprocessing/ffhq/): MTCNN detect -> Deep3DFaceRecon -> the
`3dface2idr_mat.py` pose conversion -> `preprocess_cameras.py` normalization
-> dataset.json:

  * `euler_to_rotation` - the BFM compute_rotation convention (X, Y, Z intrinsic,
    applied as R = (Rz Ry Rx)^T in the Deep3DFaceRecon code),
  * `face_recon_to_pose` - 3dface2idr_mat.py:34-70: camera at -R(angle)·(trans -
    [0,0,10]) scaled by 0.27 (+[0, 0.006, 0.161] crop offsets), OpenCV->OpenGL
    column flip,
  * `fix_pose` / `fix_pose_orig` / `fix_intrinsics` - preprocess_cameras.py:30-60
    radius-2.7 normalizations,
  * `make_dataset_labels` - cameras.json -> dataset.json 'labels' entries,
  * `flip_yaw` - the mirror-augmentation pose relabel,
  * `convert_face_recon_mats` - a directory of Deep3DFaceRecon .mat files ->
    cameras.json,
  * `extract_5p`, `pos_similarity`, `align_crop` - the in-the-wild recrop
    (PIL BICUBIC to the solved scale, LANCZOS to the output).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

FFHQ_INTRINSICS_NORMALIZED = np.array(
    [[2985.29 / 700, 0, 0.5], [0, 2985.29 / 700, 0.5], [0, 0, 1]], dtype=np.float64
)


def euler_to_rotation(angles: np.ndarray) -> np.ndarray:
    """Deep3DFaceRecon `compute_rotation`: angles [3] (x, y, z) radians ->
    R = (Rz @ Ry @ Rx).T (the BFM convention)."""
    x, y, z = angles
    Rx = np.array([[1, 0, 0], [0, np.cos(x), -np.sin(x)], [0, np.sin(x), np.cos(x)]])
    Ry = np.array([[np.cos(y), 0, np.sin(y)], [0, 1, 0], [-np.sin(y), 0, np.cos(y)]])
    Rz = np.array([[np.cos(z), -np.sin(z), 0], [np.sin(z), np.cos(z), 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).T


def face_recon_to_pose(angle: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """(angle [3], trans [3]) -> 4x4 cam2world (contract: 3dface2idr_mat.py:38-70)."""
    R = euler_to_rotation(np.asarray(angle, np.float64).reshape(3))
    trans = np.asarray(trans, np.float64).reshape(3).copy()
    trans[2] += -10.0
    c = -R @ trans
    c *= 0.27
    c[1] += 0.006
    c[2] += 0.161

    pose = np.eye(4)
    pose[:3, :3] = R @ np.diag([1.0, -1.0, -1.0])  # OpenCV -> OpenGL columns
    pose[:3, 3] = c
    return pose


def fix_pose(pose: np.ndarray, cor=np.array([0, 0, 0.175])) -> np.ndarray:
    """Recropped-image normalization (preprocess_cameras.py:44-50)."""
    pose = np.array(pose, np.float64).copy()
    location = pose[:3, 3]
    direction = (location - cor) / np.linalg.norm(location - cor)
    pose[:3, 3] = direction * 2.7 + cor
    return pose


def fix_pose_orig(pose: np.ndarray) -> np.ndarray:
    """Original-submission normalization (preprocess_cameras.py:53-57)."""
    pose = np.array(pose, np.float64).copy()
    radius = np.linalg.norm(pose[:3, 3])
    pose[:3, 3] = pose[:3, 3] / radius * 2.7
    return pose


def fix_intrinsics(intrinsics: np.ndarray) -> np.ndarray:
    """preprocess_cameras.py:30-42 — normalized FFHQ intrinsics."""
    k = np.array(intrinsics, np.float64).copy()
    assert k.shape == (3, 3)
    return FFHQ_INTRINSICS_NORMALIZED.copy()


def flip_yaw(pose: np.ndarray) -> np.ndarray:
    """Mirror-augmentation pose relabel (the matrix form of the dataset loader's
    label[[1,2,3,4,8]] *= -1, dataset_seg.py:387)."""
    flipped = np.array(pose, np.float64).copy()
    flipped[0, 1] *= -1
    flipped[0, 2] *= -1
    flipped[1, 0] *= -1
    flipped[2, 0] *= -1
    flipped[0, 3] *= -1
    return flipped


def make_dataset_labels(
    cameras: Dict[str, dict], mode: str = "cor", mirror: bool = False
) -> dict:
    """cameras.json dict -> {'labels': [[fname, 25-dim], ...]}
    (contract: preprocess_cameras.py:62-119)."""
    fixer = {"cor": fix_pose, "orig": fix_pose_orig}[mode]
    labels = []
    for fname, cam in cameras.items():
        pose = fixer(np.array(cam["pose"]))
        intr = fix_intrinsics(np.array(cam["intrinsics"]))
        labels.append([fname, np.concatenate([pose.reshape(-1), intr.reshape(-1)]).tolist()])
        if mirror:
            fpose = flip_yaw(pose)
            base, ext = fname.rsplit(".", 1)
            labels.append(
                [f"{base}_mirror.{ext}",
                 np.concatenate([fpose.reshape(-1), intr.reshape(-1)]).tolist()]
            )
    return {"labels": labels}


def convert_face_recon_mats(in_root: str, out_path: Optional[str] = None) -> dict:
    """Directory of Deep3DFaceRecon .mat files -> cameras.json
    (3dface2idr_mat.py main loop)."""
    import os

    import scipy.io

    out = {}
    for f in sorted(os.listdir(in_root)):
        if not f.endswith(".mat"):
            continue
        m = scipy.io.loadmat(os.path.join(in_root, f))
        pose = face_recon_to_pose(m["angle"], m["trans"][0])
        K = np.eye(3)
        K[0, 0] = K[1, 1] = 2985.29
        K[0, 2] = K[1, 2] = 512.0
        out[f.replace(".mat", ".jpg")] = {"pose": pose.tolist(), "intrinsics": K.tolist()}
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(out, fh)
    return out


# ------------------------------------------------------------ crop / alignment
#
# The reference's in-the-wild crop (crop_images_in_the_wild.py:43-61) calls
# Deep3DFaceRecon's `align_img` (an EMPTY git submodule in the reference tree).
# The algorithm is standard public math: solve a least-squares similarity
# transform (the "POS" linear pose solve) from the 5 facial landmarks to the BFM
# standard 3D landmark positions, rescale the image so the face spans
# `rescale_factor` pixels at `target_size`, center on the solved translation,
# then center-crop `center_crop_size` and resize to `output_size` (the IDE-3D/
# EG3D FFHQ convention: 1024 -> 700 crop -> 512).

# BFM standard 5-point landmarks (x, y, z), the similarity-transform target.
# These are dataset constants (from the public BFM similarity_Lm3D_all.mat
# reduction), not code.
LM3D_STD = np.array(
    [
        [-0.31148657, 0.09036078, 0.13377953],   # left eye
        [0.30979887, 0.08972035, 0.13179526],    # right eye
        [0.0032535, -0.24617933, 0.55244243],    # nose tip
        [-0.25216928, -0.5813392, 0.22405732],   # left mouth corner
        [0.2484662, -0.5812824, 0.22235769],     # right mouth corner
    ],
    dtype=np.float64,
)


def extract_5p(lm: np.ndarray) -> np.ndarray:
    """68-point landmarks -> 5 (eye centers, nose, mouth corners)."""
    lm = np.asarray(lm, np.float64)
    if lm.shape[0] == 5:
        return lm
    idx = np.array([31, 37, 40, 43, 46, 49, 55]) - 1
    p5 = np.stack(
        [
            lm[idx[[1, 2]]].mean(0),  # left eye center
            lm[idx[[3, 4]]].mean(0),  # right eye center
            lm[idx[0]],               # nose tip
            lm[idx[5]],               # left mouth corner
            lm[idx[6]],               # right mouth corner
        ]
    )
    return p5


def pos_similarity(xp: np.ndarray, x3d: np.ndarray):
    """Least-squares scale + 2D translation mapping 3D std landmarks to image
    landmarks (the POS solve): xp ~ s * x3d[:, :2]-ish via the linear system
    A @ [r1; tx; r2; ty] = b with row-orthogonal R absorbed into s.

    xp: [N, 2] image points (y up), x3d: [N, 3]. Returns (t [2], s scalar)."""
    npts = xp.shape[0]
    A = np.zeros((2 * npts, 8))
    x_h = np.concatenate([x3d, np.ones((npts, 1))], axis=1)  # [N, 4]
    A[0::2, 0:4] = x_h
    A[1::2, 4:8] = x_h
    b = xp.reshape(-1, 1)
    k, *_ = np.linalg.lstsq(A, b, rcond=None)
    R1, R2 = k[0:3], k[4:7]
    sTx, sTy = float(k[3, 0]), float(k[7, 0])
    s = (np.linalg.norm(R1) + np.linalg.norm(R2)) / 2.0
    return np.array([sTx, sTy]), float(s)


def align_crop(
    img: np.ndarray,  # [H, W, 3] uint8
    lm: np.ndarray,   # [N>=5, 2] landmarks in IMAGE coords (y down)
    lm3d_std: np.ndarray = LM3D_STD,
    target_size: float = 1024.0,
    rescale_factor: float = 300.0,
    center_crop_size: int = 700,
    output_size: int = 512,
) -> np.ndarray:
    """The in-the-wild FFHQ recrop (crop_images_in_the_wild.py:43-61 semantics).

    Returns the aligned [output_size, output_size, 3] uint8 crop."""
    import PIL.Image

    H = img.shape[0]
    lm = extract_5p(np.asarray(lm, np.float64))
    lm_flip = lm.copy()
    lm_flip[:, 1] = H - 1 - lm_flip[:, 1]  # y up for the solve (reference :44-45)

    t, s = pos_similarity(lm_flip, lm3d_std)
    s = rescale_factor / max(s, 1e-8)

    # resize so the face spans rescale_factor px, then crop target_size about
    # the solved center (align_img 'resize_n_crop_img' semantics: the solved
    # translation is in y-up original-image coords)
    w0, h0 = img.shape[1], img.shape[0]
    im = PIL.Image.fromarray(img)
    w, h = int(round(w0 * s)), int(round(h0 * s))
    im = im.resize((w, h), resample=PIL.Image.BICUBIC)

    left = int(round(w / 2 - target_size / 2 + (t[0] - w0 / 2) * s))
    up = int(round(h / 2 - target_size / 2 + (h0 / 2 - t[1]) * s))
    im = im.crop((left, up, left + int(target_size), up + int(target_size)))

    # center crop + final resize (crop_images_in_the_wild.py:54-60)
    l2 = int(im.size[0] / 2 - center_crop_size / 2)
    u2 = int(im.size[1] / 2 - center_crop_size / 2)
    im = im.crop((l2, u2, l2 + center_crop_size, u2 + center_crop_size))
    im = im.resize((output_size, output_size), resample=PIL.Image.LANCZOS)
    return np.asarray(im, np.uint8)
