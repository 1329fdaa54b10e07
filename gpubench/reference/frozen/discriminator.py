"""StyleGAN2 discriminator with the IDE-3D dual-branch input, in PyTorch.

Counterpart of ide3d_tpu/models/discriminator.py: residual
`DiscriminatorBlock`s from the input resolution down to 8², the minibatch
standard deviation with STRIDED groups (sample s belongs to group s mod n), the
4² `DiscriminatorEpilogue` and the conditioning `MappingNetwork` on the 25-dim
camera label (projection discriminator). The input is NHWC, as in the JAX
package: the 512² RGB ++ the upsampled raw render (6 channels), plus the 19
semantic channels for the seg-conditioned D (25). Blocks run in the configured
compute dtype (bf16 on the card), the epilogue in fp32. Module and parameter
names follow the JAX tree, so io/from_jax.load_jax_params loads it. Under
a data-parallel group the minibatch stddev spans the global batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ._mesh import Group, gather_rows, rows
from .blocks import DTYPES
from .layers import CONV_CLAMP, Conv2dLayer, FullyConnectedLayer, init_seeded
from .mapping import MappingNetwork


class DiscriminatorBlock(nn.Module):
    """Residual block `b{res}`: fromrgb (first block only), conv0, conv1 with
    a 2x FIR downsample, and a 1x1 downsampling skip; both branches at gain sqrt(1/2)."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int, img_channels: int,
                 dtype: str = "float32"):
        super().__init__()
        self.in_channels = in_channels
        self.dtype = DTYPES[dtype]
        if in_channels == 0:
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, 1, activation="lrelu",
                                       conv_clamp=CONV_CLAMP)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, 3, activation="lrelu",
                                 conv_clamp=CONV_CLAMP)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, 3, down=2, activation="lrelu",
                                 conv_clamp=CONV_CLAMP)
        self.skip = Conv2dLayer(tmp_channels, out_channels, 1, bias=False, down=2)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, in, r, r] (None for the first block), img [B, img_channels, r, r]."""
        if x is not None:
            x = x.to(self.dtype)
        if self.in_channels == 0:
            y = self.fromrgb(img.to(self.dtype))
            x = y if x is None else x + y
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv1(self.conv0(x), gain=math.sqrt(0.5))
        return y + x


def minibatch_stddev(x: torch.Tensor, group_size: Optional[int] = 4, num_channels: int = 1,
                     group: Optional[Group] = None) -> torch.Tensor:
    """NCHW x -> x ++ num_channels feature maps of the group standard deviation.

    Groups are strided: sample s belongs to group s mod n, n = N // G, so that
    out[s] = y[s mod n] as in the reference. Computed as the JAX package does,
    through an [N, N] group-membership average over a flat [N, C*H*W] view, in fp32.

    With a data-parallel `group`, N is the GLOBAL batch, as in the JAX step
    (one logical array over the mesh): the ranks' flat rows are all-gathered,
    differentiably to any order (parallel/mesh.gather_rows), and each rank
    keeps its own rows of y."""
    b, C, H, W = x.shape
    xf = x.reshape(b, -1).float()
    if group is not None and group.distributed:
        xf = gather_rows(group, xf)
    N = xf.shape[0]
    G = min(group_size, N) if group_size is not None else N
    n = N // G
    idx = torch.arange(N, device=x.device)
    M = ((idx[:, None] % n) == (idx[None, :] % n)).float() / G  # row s averages over group(s)
    mean = M @ xf
    std = torch.sqrt(M @ (xf - mean).square() + 1e-8)
    y = std.reshape(N, num_channels, C // num_channels, H, W).mean(dim=(2, 3, 4))  # [N, F]
    if group is not None and group.distributed:
        y = y[rows(group, N)]
    y = y[:, :, None, None].expand(b, num_channels, H, W).to(x.dtype)
    return torch.cat([x, y], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """`b4`: minibatch stddev, 3x3 conv, fc, out; projection onto the label's cmap."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int = 4,
                 mbstd_group_size: int = 4, mbstd_num_channels: int = 1):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, 3,
                                activation="lrelu", conv_clamp=CONV_CLAMP)
        self.fc = FullyConnectedLayer(in_channels * resolution**2, in_channels, activation="lrelu")
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim)

    def forward(self, x: torch.Tensor, cmap: Optional[torch.Tensor],
                group: Optional[Group] = None) -> torch.Tensor:
        x = x.float()
        if self.mbstd_num_channels > 0:
            x = minibatch_stddev(x, self.mbstd_group_size, self.mbstd_num_channels, group)
        x = self.conv(x)
        x = self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))  # the JAX (H, W, C) order
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) * (1.0 / math.sqrt(self.cmap_dim))
        return x


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    c_dim: int = 25
    img_resolution: int = 512
    img_channels: int = 6  # RGB ++ upsampled raw render; 25 adds the semantic mask
    channel_base: int = 32768
    channel_max: int = 512
    cmap_dim: Optional[int] = None
    mapping_num_layers: int = 8
    dtype: str = "bfloat16"


class Discriminator(nn.Module):
    """D(img NHWC [B, R, R, img_channels], c [B, c_dim]) -> logits [B, 1]."""

    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        for res in self.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                in_channels=self._channels(res) if res < cfg.img_resolution else 0,
                tmp_channels=self._channels(res), out_channels=self._channels(res // 2),
                img_channels=cfg.img_channels, dtype=cfg.dtype))
        self.mapping = None
        if cfg.c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=cfg.c_dim, w_dim=self.cmap_dim,
                                          num_ws=None, num_layers=cfg.mapping_num_layers)
        self.b4 = DiscriminatorEpilogue(self._channels(4), cmap_dim=self.cmap_dim)

    @property
    def block_resolutions(self) -> tuple:
        log2 = int(math.log2(self.cfg.img_resolution))
        return tuple(2**i for i in range(log2, 2, -1))

    def _channels(self, res: int) -> int:
        return min(self.cfg.channel_base // res, self.cfg.channel_max)

    @property
    def cmap_dim(self) -> int:
        if self.cfg.c_dim == 0:
            return 0
        return self._channels(4) if self.cfg.cmap_dim is None else self.cfg.cmap_dim

    @property
    def mbstd_group_size(self) -> int:
        return self.b4.mbstd_group_size

    def init(self, seed: int = 0) -> "Discriminator":
        """Draw every weight from a CPU torch.Generator seeded with `seed`. Returns self."""
        return init_seeded(self, seed)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor],
                group: Optional[Group] = None) -> torch.Tensor:
        """`group`: the data-parallel group whose global batch the minibatch
        stddev spans (None: this call's batch)."""
        img = img.permute(0, 3, 1, 2)
        x = None
        for res in self.block_resolutions:
            x = getattr(self, f"b{res}")(x, img if res == self.cfg.img_resolution else None)
        cmap = self.mapping(None, c) if self.mapping is not None else None
        return self.b4(x, cmap, group)
