"""Tri-plane and feature-volume lookups, plain PyTorch.

Counterpart of `sample_from_triplane` / `sample_from_quad_table` and
`grid_sample_3d` (which `sample_from_3dgrid` calls with its arguments swapped)
in ide3d_tpu/ops/grid_sample.py: the feature of a point is the sum of three
bilinear samples, from the xy, yz and xz planes, with zeros padding and
align_corners=False. The JAX package gathers through a 2x2-neighbourhood
("quad") table, a TPU gather layout; here each plane is one F.grid_sample call.

Sampling runs in fp32 with fp32 coordinates, whatever the planes' dtype, and
the result comes back in the planes' dtype: F.grid_sample needs the grid in the
input's dtype, and a bf16 grid would lose up to half a texel on a 256² plane.
The feature volume of the hybrid generator is sampled trilinearly by one 5-D
F.grid_sample call, which computes what the JAX package's XLA gather does.
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


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear point sampling of a feature volume with zeros padding and
    align_corners=True (the JAX package's grid_sample_3d):
    volume [B, C, D, H, W], coords [B, N, 3] in [-1, 1] with x indexing W, y H
    and z D -> [B, N, C]. The JAX volume is channels-last [B, D, H, W, C]; here
    it is NCDHW, the layout of F.conv3d and F.grid_sample.

    As the tri-plane lookup, it samples in fp32 with fp32 coordinates and
    returns the volume's dtype (the JAX package lerps in the volume's dtype)."""
    if volume.ndim != 5 or coords.ndim != 3 or coords.shape[-1] != 3 or coords.shape[0] != volume.shape[0]:
        raise ValueError(f"expected volume [B,C,D,H,W] and coords [B,N,3], got "
                         f"{tuple(volume.shape)}, {tuple(coords.shape)}")
    grid = coords.float()[:, None, None]  # [B, 1, 1, N, 3]
    s = F.grid_sample(volume.float(), grid, mode="bilinear", padding_mode="zeros",
                      align_corners=True)  # [B, C, 1, 1, N]
    return s[:, :, 0, 0].transpose(1, 2).to(volume.dtype)

