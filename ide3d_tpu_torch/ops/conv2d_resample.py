"""2D convolution with optional FIR up/downsampling (NCHW / OIHW), plain PyTorch.

Counterpart of ide3d_tpu/ops/conv2d_resample.py, with its algebra:
  * up == down == 1 -> one conv2d with the (symmetric) padding,
  * up > 1          -> zero insertion + FIR through `upfirdn2d` with gain up^2,
                       then the conv (and an FIR downsample if down > 1),
  * down > 1        -> FIR low-pass through `upfirdn2d`, then a strided conv.
Padding is taken w.r.t. the upsampled image. `flip_weight=True` is correlation
(what F.conv2d computes); `flip_weight=False` flips the kernel spatially.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .upfirdn2d import FilterArg, _parse_padding, get_filter_size, upfirdn2d


def _conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    padding: tuple[int, int, int, int] = (0, 0, 0, 0),  # (px0, px1, py0, py1)
    groups: int = 1,
    flip_weight: bool = True,
) -> torch.Tensor:
    if not flip_weight:
        w = w.flip([2, 3])
    px0, px1, py0, py1 = padding
    if px0 == px1 and py0 == py1:
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(py0, px0), groups=groups)
    x = F.pad(x, [px0, px1, py0, py1])
    return F.conv2d(x, w.to(x.dtype), stride=stride, groups=groups)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[FilterArg] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
) -> torch.Tensor:
    """Convolve NCHW `x` with OIHW `w`, resampling by `up`/`down` with FIR `f`."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NCHW x and OIHW w, got {tuple(x.shape)}, {tuple(w.shape)}")
    fw, fh = get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up == 1 and down == 1:
        return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups, flip_weight=flip_weight)

    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    x = upfirdn2d(
        x, f if up > 1 else None, up=up, padding=(px0, px1, py0, py1),
        gain=up**2, flip_filter=flip_filter,
    )
    x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
