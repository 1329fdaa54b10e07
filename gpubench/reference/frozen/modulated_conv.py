"""Style-modulated convolution (StyleGAN2), plain PyTorch on cuDNN convs.

Counterpart of ide3d_tpu/ops/modulated_conv.py, in the same input/output
scaling form:

    y = conv(x * styles, W) * dcoefs (+ noise)
    dcoef[b,o] = rsqrt(sum_i styles[b,i]^2 * wsq[o,i] + 1e-8),  wsq = sum_{kh,kw} W^2

The demodulation coefficients come from one [B,I]x[I,O] product taken in fp32;
no per-sample weights are materialised, and the conv is one batched conv2d.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv2d_resample import conv2d_resample
from .upfirdn2d import FilterArg


def modulated_conv2d(
    x: torch.Tensor,  # [B, I, H, W]
    weight: torch.Tensor,  # [O, I, kh, kw]
    styles: torch.Tensor,  # [B, I]
    noise: Optional[torch.Tensor] = None,  # broadcastable to the output, added last
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[FilterArg] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
) -> torch.Tensor:
    if x.ndim != 4 or weight.ndim != 4 or styles.ndim != 2:
        raise ValueError("expected x [B,I,H,W], weight [O,I,kh,kw], styles [B,I]")
    in_channels = x.shape[1]
    if weight.shape[1] != in_channels or styles.shape[1] != in_channels:
        raise ValueError(f"channel mismatch: x {in_channels}, weight {weight.shape[1]}, "
                         f"styles {styles.shape[1]}")

    dtype = x.dtype
    x = x * styles.to(dtype)[:, :, None, None]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)

    if demodulate:
        wsq = weight.float().square().sum(dim=(2, 3))  # [O, I]
        ssq = styles.float().square()  # [B, I]
        dcoefs = torch.rsqrt(ssq @ wsq.t() + 1e-8).to(dtype)  # [B, O]
        x = x * dcoefs[:, :, None, None]

    if noise is not None:
        x = x + noise.to(dtype)
    return x
