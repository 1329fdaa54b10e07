"""Filtered leaky ReLU (the StyleGAN3 alias-free nonlinearity), plain PyTorch.

Counterpart of ide3d_tpu/ops/filtered_lrelu.py, in the same order: the bias,
the FIR upsample by `up` (gain up^2), the leaky ReLU with its gain and clamp,
then the FIR downsample by `down`. Built from the port's own bias_act and
upfirdn2d, on NCHW images; `padding` is taken w.r.t. the upsampled image.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .bias_act import bias_act
from .upfirdn2d import FilterArg, upfirdn2d


def filtered_lrelu(
    x: torch.Tensor,  # [N, C, H, W]
    fu: FilterArg = None,
    fd: FilterArg = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2.0),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up**2, flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
