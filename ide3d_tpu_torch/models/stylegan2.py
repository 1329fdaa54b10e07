"""Plain 2D StyleGAN2 generator, skip or 'orig' architecture.

Counterpart of ide3d_tpu/models/stylegan2.py: the network TF1-era legacy
pickles convert into (the reference's legacy.py:143-245 builds
`networks_stylegan2.Generator` from the TF variables; io/tf_legacy.py builds
its state dict). IDE-3D itself never instantiates it; it hosts old StyleGAN2
checkpoints. It is made of the layers the superres stack uses
(`MappingNetwork`, `SynthesisBlock`, `SynthesisLayer`, `ToRGBLayer`), and
its tensor names are those of the reference's state dict (`mapping.fc{i}.*`,
`mapping.w_avg`, `synthesis.b4.const`, `synthesis.b{res}.conv0 | conv1 |
torgb.*`). Images come out NHWC in [-1, 1], as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from .blocks import SynthesisBlock
from .layers import SynthesisLayer, ToRGBLayer, init_seeded
from .mapping import MappingNetwork


@dataclasses.dataclass(frozen=True)
class StyleGan2Config:
    """The kwargs legacy.py:150-181 recovers from a TF pickle."""

    z_dim: int = 512
    c_dim: int = 0
    w_dim: int = 512
    img_resolution: int = 1024
    img_channels: int = 3
    channel_base: int = 32768  # fmap_base * 2 (legacy.py:163)
    channel_max: int = 512
    conv_clamp: Optional[float] = 256.0
    mapping_num_layers: int = 8
    mapping_embed_features: Optional[int] = None
    # 'skip' (a ToRGB per resolution, summed into the upsampled running image)
    # or 'orig' (progressive era: one ToRGB on the last block; what TF
    # ToRGB_lod checkpoints convert into, legacy.py:196-200)
    architecture: str = "skip"


class _B4(nn.Module):
    """The 4x4 block: a learned const, one modulated conv and (skip, or a
    4x4 generator) a ToRGB."""

    def __init__(self, cfg: StyleGan2Config, channels: int, torgb: bool):
        super().__init__()
        self.const = nn.Parameter(torch.empty(channels, 4, 4))
        self.conv1 = SynthesisLayer(channels, channels, cfg.w_dim, 4, conv_clamp=cfg.conv_clamp)
        self.torgb = (ToRGBLayer(channels, cfg.img_channels, cfg.w_dim, conv_clamp=cfg.conv_clamp)
                      if torgb else None)

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.const.normal_(generator=generator)


class StyleGan2Synthesis(nn.Module):
    """ws [B, num_ws, w_dim] -> img [B, R, R, img_channels] in [-1, 1]: `b4`,
    then a SynthesisBlock per resolution up to R."""

    def __init__(self, cfg: StyleGan2Config):
        super().__init__()
        self.cfg = cfg
        self.orig = cfg.architecture == "orig"
        R = cfg.img_resolution
        self.block_resolutions = tuple(2**i for i in range(2, int(math.log2(R)) + 1))
        self.b4 = _B4(cfg, self._channels(4), torgb=not self.orig or R == 4)
        for res in self.block_resolutions[1:]:
            blk = SynthesisBlock(self._channels(res // 2), self._channels(res), cfg.w_dim, res,
                                 cfg.img_channels, up=2, conv_clamp=cfg.conv_clamp)
            if self.orig and res != R:
                blk.torgb = None  # 'orig': only the last block holds a ToRGB
            setattr(self, f"b{res}", blk)

    def _channels(self, res: int) -> int:
        return min(self.cfg.channel_base // res, self.cfg.channel_max)

    def forward(self, ws: torch.Tensor, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.b4.const[None].expand(ws.shape[0], -1, -1, -1)
        x = self.b4.conv1(x, ws[:, 0], noise_mode=noise_mode, generator=generator)
        if self.orig:
            w_i, last = 1, self.b4
            for res in self.block_resolutions[1:]:
                last = getattr(self, f"b{res}")
                x = last.conv0(x, ws[:, w_i], noise_mode=noise_mode, generator=generator)
                x = last.conv1(x, ws[:, w_i + 1], noise_mode=noise_mode, generator=generator)
                w_i += 2
            img = last.torgb(x, ws[:, w_i])
        else:
            img = self.b4.torgb(x, ws[:, 1])
            w_i = 1  # a block's torgb row is the next block's conv0 row
            for res in self.block_resolutions[1:]:
                x, img = getattr(self, f"b{res}")(x, img, ws[:, w_i:w_i + 3],
                                                  noise_mode=noise_mode, generator=generator)
                w_i += 2
        return img.permute(0, 2, 3, 1)


class StyleGan2Generator(nn.Module):
    """G(z [B, z_dim], c) -> img [B, R, R, img_channels] (NHWC, fp32), as
    `synthesis(mapping(z, c))`."""

    def __init__(self, cfg: StyleGan2Config):
        super().__init__()
        if cfg.architecture not in ("skip", "orig"):
            raise ValueError(f"architecture must be 'skip' or 'orig', got {cfg.architecture!r}")
        self.cfg = cfg
        self.synthesis = StyleGan2Synthesis(cfg)
        self.mapping = MappingNetwork(z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                                      num_ws=self.num_ws, num_layers=cfg.mapping_num_layers,
                                      embed_features=cfg.mapping_embed_features)

    @property
    def block_resolutions(self) -> tuple:
        return self.synthesis.block_resolutions

    @property
    def num_ws(self) -> int:
        # b4 takes (conv1, torgb); each later block 3 rows, its torgb row shared
        # with the next block's conv0
        return 2 * len(self.block_resolutions)

    def init(self, seed: int = 0) -> "StyleGan2Generator":
        """Draw every weight from a CPU torch.Generator seeded with `seed`. Returns self."""
        return init_seeded(self, seed)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0, noise_mode: str = "const",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode, generator=generator)
