"""Pad -> upsample -> FIR filter -> downsample for NCHW images, plain PyTorch.

Counterpart of ide3d_tpu/ops/upfirdn2d.py with the same semantics:
  1. zero insertion by `up` (each pixel followed by up-1 zeros),
  2. padding (negative = crop) taken w.r.t. the upsampled image,
  3. FIR filtering with `f`; flip_filter=False means true convolution, so the
     filter is flipped before the (correlating) depthwise conv2d,
  4. keeping every `down`-th pixel.
A separable filter ([taps]) runs as two 1-D passes. The JAX package keeps the
data channels-last; here it is NCHW, cuDNN's layout.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

FilterArg = Union[None, Sequence[float], np.ndarray, torch.Tensor]


def _parse_scaling(scaling) -> tuple[int, int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def setup_filter(
    f: FilterArg,
    normalize: bool = True,
    flip_filter: bool = False,
    gain: float = 1.0,
    separable: Optional[bool] = None,
) -> torch.Tensor:
    """Prepare a FIR filter for `upfirdn2d`: float32 `[taps]` if separable,
    else `[fh, fw]` (a 1-D filter of fewer than 8 taps becomes its outer product)."""
    if f is None:
        f = 1
    f = torch.as_tensor(np.asarray(f, dtype=np.float32))
    if f.ndim not in (0, 1, 2) or f.numel() == 0:
        raise ValueError(f"filter must be a non-empty 0/1/2-D array, got {tuple(f.shape)}")
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = f.ndim == 1 and f.numel() >= 8
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if f.ndim != (1 if separable else 2):
        raise ValueError("a 2-D filter cannot be separable")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return f.contiguous()


def get_filter_size(f: FilterArg) -> tuple[int, int]:
    if f is None:
        return 1, 1
    shape = tuple(f.shape) if isinstance(f, torch.Tensor) else np.shape(f)
    if len(shape) == 1:
        return int(shape[0]), int(shape[0])
    return int(shape[1]), int(shape[0])


def upfirdn2d(
    x: torch.Tensor,
    f: FilterArg,
    up=1,
    down=1,
    padding=0,
    flip_filter: bool = False,
    gain: float = 1.0,
) -> torch.Tensor:
    """Pad, upsample, FIR-filter and downsample a batch of NCHW images."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    if f is None:
        f = torch.ones(1, 1, dtype=torch.float32)
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {tuple(f.shape)}")
    B, C, H, W = x.shape

    # Zero insertion: [B,C,H,1,W,1] padded to [B,C,H,up,W,up].
    if upx > 1 or upy > 1:
        x = x.reshape(B, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(B, C, H * upy, W * upx)

    # Pad, then crop (negative padding).
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]

    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f.to(x.dtype)
    if f.ndim == 2:
        x = F.conv2d(x, f[None, None].repeat(C, 1, 1, 1), groups=C)
    else:
        x = F.conv2d(x, f[None, None, None, :].repeat(C, 1, 1, 1), groups=C)
        x = F.conv2d(x, f[None, None, :, None].repeat(C, 1, 1, 1), groups=C)

    if downx > 1 or downy > 1:
        x = x[:, :, ::downy, ::downx]
    return x


def filter2d(x: torch.Tensor, f: FilterArg, padding=0, flip_filter=False, gain=1.0) -> torch.Tensor:
    """Same-size FIR filtering."""
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = (px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x: torch.Tensor, f: FilterArg, up=2, padding=0, flip_filter=False, gain=1.0) -> torch.Tensor:
    """FIR upsample by `up`."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = (
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    )
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x: torch.Tensor, f: FilterArg, down=2, padding=0, flip_filter=False, gain=1.0) -> torch.Tensor:
    """FIR downsample by `down`."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = (
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    )
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
