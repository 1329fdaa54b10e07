"""The VolumeGAN feature volume: the voxel branch of the hybrid tri-plane/voxel
representation (IDE-3D paper Sec. 3.1).

Counterpart of ide3d_tpu/models/feature_volume.py: a learned 4^3 constant
grown by x2 trilinear resizes through 3x3x3 convs ("SAME", padding 1), each
followed by an instance norm over D, H and W (eps 1e-8) with a per-channel
scale and shift from one FC mapping of the latent, and a plain leaky ReLU
(slope 0.2, no gain). Volumes are NCDHW here ([B, C, D, H, W]); the JAX
package keeps them channels-last. The conv weights are stored at their
working scale (drawn N(0, 1) / sqrt(in * 27)), as in the JAX tree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FullyConnectedLayer

INIT_RES = 4  # the side of the learned constant


def conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, Cin, D, H, W], w [Cout, Cin, 3, 3, 3] -> "SAME" conv, stride 1."""
    return F.conv3d(x, w.to(x.dtype), padding=w.shape[-1] // 2)


def instance_norm_3d(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None, eps: float = 1e-8) -> torch.Tensor:
    """Normalize each channel over D, H, W; then x * scale + shift ([B, C] each)."""
    x = x - x.mean(dim=(2, 3, 4), keepdim=True)
    x = x * torch.rsqrt(x.square().mean(dim=(2, 3, 4), keepdim=True) + eps)
    if scale is not None:
        x = x * scale[:, :, None, None, None] + shift[:, :, None, None, None]
    return x


class _Conv3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(math.sqrt(self.weight.shape[1] * 27))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(x, self.weight) + self.bias.to(x.dtype)[:, None, None, None]


class FeatureVolume(nn.Module):
    """forward(z [B, z_dim]) -> volume [B, output_channels, feat_res, feat_res, feat_res]."""

    def __init__(self, feat_res: int = 32, base_channels: int = 256, output_channels: int = 32,
                 z_dim: int = 256, use_mapping: bool = True):
        super().__init__()
        self.feat_res = feat_res
        self.base_channels, self.output_channels = base_channels, output_channels
        self.use_mapping = use_mapping
        self.const = nn.Parameter(torch.ones(1, base_channels, INIT_RES, INIT_RES, INIT_RES))
        in_ch = base_channels
        for i, out_ch in enumerate(self.stage_channels()):
            setattr(self, f"layer{i}", _Conv3d(in_ch, out_ch))
            in_ch = out_ch
        self.mapping = (FullyConnectedLayer(z_dim, 2 * sum(self.stage_channels()))
                        if use_mapping else None)

    @property
    def num_stages(self) -> int:
        return int(math.log2(self.feat_res // INIT_RES)) + 1

    def stage_channels(self) -> list:
        """Channels after each stage: halving from base_channels, never below
        output_channels, and output_channels at the last stage."""
        chans, out = [], self.base_channels
        for i in range(self.num_stages):
            chans.append(out)
            out = max(out // 2, self.output_channels)
            if i == self.num_stages - 2:
                out = self.output_channels
        return chans

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.const.fill_(1.0)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        B = z.shape[0]
        scales = shifts = None
        if self.mapping is not None:
            scales, shifts = self.mapping(z).chunk(2, dim=-1)
        x = self.const.to(z.dtype).expand(B, -1, -1, -1, -1)
        off = 0
        for i, out_ch in enumerate(self.stage_channels()):
            if i != 0:
                x = F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)
            x = getattr(self, f"layer{i}")(x)
            if scales is not None:
                x = instance_norm_3d(x, scales[:, off:off + out_ch], shifts[:, off:off + out_ch])
            else:
                x = instance_norm_3d(x)
            x = F.leaky_relu(x, 0.2)
            off += out_ch
        return x
