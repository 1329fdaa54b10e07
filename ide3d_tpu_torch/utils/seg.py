"""19-class face-semantics colorization (counterpart of ide3d_tpu/utils/seg.py)."""

from __future__ import annotations

import numpy as np
import torch

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


def mask2color(seg: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] class scores -> [B, H, W, 3] RGB in 0..255 (float32)."""
    palette = torch.as_tensor(COLOR_MAP, device=seg.device)
    return palette[seg.argmax(dim=-1)]
