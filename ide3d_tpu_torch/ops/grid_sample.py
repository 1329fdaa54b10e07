"""Tri-plane feature lookup, plain PyTorch.

Counterpart of `sample_from_triplane` / `sample_from_quad_table` in
ide3d_tpu/ops/grid_sample.py: the feature of a point is the sum of three
bilinear samples, from the xy, yz and xz planes, with zeros padding and
align_corners=False. The JAX package gathers through a 2x2-neighbourhood
("quad") table, a TPU gather layout; here each plane is one F.grid_sample call.

Sampling runs in fp32 with fp32 coordinates, whatever the planes' dtype, and
the result comes back in the planes' dtype: F.grid_sample needs the grid in the
input's dtype, and a bf16 grid would lose up to half a texel on a 256² plane.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_from_triplane(coords: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """coords [B, N, 3] in [-1, 1]; planes [B, H, W, 3*C] (xy | yz | xz on the
    channel axis) -> [B, N, C] = xy(x, y) + yz(y, z) + xz(x, z)."""
    B, H, W, C3 = planes.shape
    if C3 % 3 or coords.shape[0] != B or coords.shape[-1] != 3:
        raise ValueError(f"expected coords [B,N,3] and planes [B,H,W,3*C], got "
                         f"{tuple(coords.shape)}, {tuple(planes.shape)}")
    p32 = planes.float().reshape(B, H, W, 3, C3 // 3)
    x, y, z = coords.float().unbind(-1)
    out = None
    for k, (u, v) in enumerate(((x, y), (y, z), (x, z))):
        grid = torch.stack([u, v], dim=-1)[:, None]  # [B, 1, N, 2]; u indexes W, v indexes H
        img = p32[:, :, :, k].permute(0, 3, 1, 2)  # [B, C, H, W] view, channels innermost
        s = F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        out = s if out is None else out + s
    return out[:, :, 0].transpose(1, 2).to(planes.dtype)
