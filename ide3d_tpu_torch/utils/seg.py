"""19-class face-semantics toolkit: palette, label names, one-hot and
colorization (counterpart of ide3d_tpu/utils/seg.py). Masks are integer
[..., H, W]; class scores and one-hots are channels-last [..., H, W, 19]."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# The published 19-class palette (dnnlib/seg_tools.py:13-32 of IDE-3D).
COLOR_MAP = np.array(
    [
        [0, 0, 0], [204, 0, 0], [76, 153, 0], [204, 204, 0], [51, 51, 255],
        [204, 0, 204], [0, 255, 255], [255, 204, 204], [102, 51, 0], [255, 0, 0],
        [102, 204, 0], [255, 255, 0], [0, 0, 153], [0, 0, 204], [255, 51, 153],
        [0, 204, 204], [0, 51, 0], [255, 153, 51], [0, 204, 0],
    ],
    dtype=np.float32,
)

# Class names and ids (dnnlib/seg_tools.py:35-55 of IDE-3D).
LABEL_LIST = {
    "background": 0, "skin": 1, "nose": 2, "eye_g": 3, "l_eye": 4, "r_eye": 5,
    "l_brow": 6, "r_brow": 7, "l_ear": 8, "r_ear": 9, "mouth": 10, "u_lip": 11,
    "l_lip": 12, "hair": 13, "hat": 14, "ear_r": 15, "neck_l": 16, "neck": 17,
    "cloth": 18,
}

# BiSeNet's 20 class ids -> the 19 IDE-3D ids (dnnlib/seg_tools.py:63 of IDE-3D).
BISENET_REMAP = np.array(
    [0, 1, 6, 7, 4, 5, 2, 2, 10, 11, 12, 8, 9, 15, 3, 17, 16, 18, 13, 14], dtype=np.int64)

NUM_CLASSES = 19


def id_remap(seg: torch.Tensor) -> torch.Tensor:
    """BiSeNet class ids [...] -> IDE-3D class ids [...] (int64)."""
    return torch.as_tensor(BISENET_REMAP, device=seg.device)[seg.long()]


def mask2onehot(mask: torch.Tensor, num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """Integer mask [..., H, W] -> float32 one-hot [..., H, W, num_classes]."""
    return F.one_hot(mask.long(), num_classes).float()


def onehot2mask(onehot: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] class scores -> integer mask [..., H, W]."""
    return onehot.argmax(dim=-1)


def mask2color(seg: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] class scores -> [B, H, W, 3] RGB in 0..255 (float32)."""
    palette = torch.as_tensor(COLOR_MAP, device=seg.device)
    return palette[seg.argmax(dim=-1)]
