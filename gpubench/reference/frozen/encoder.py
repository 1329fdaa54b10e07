"""Inversion encoders: Encoder and HybridEncoder.

Counterpart of ide3d_tpu/models/encoder.py, with its contracts
(inversion/networks.py of IDE-3D):
  * EncoderResBlock: conv3x3 lrelu -> conv3x3 down-2 lrelu, plus a 1x1 down-2
    skip without bias; the sum divided by sqrt(2),
  * a pyramid: 1x1 stem -> resblocks from `size` down to 4^2 -> a 4x4 VALID
    projector (gain 1/sqrt(in*16), no bias) emitting n_latents * w_dim,
  * HybridEncoder: an image pyramid (3 ch) for the 10 appearance rows and a
    seg pyramid (19 ch) for the 8 geometry rows, concatenated SEG-FIRST
    (geometry rows 0..7, appearance rows 8..17).

Inputs are NHWC as in the JAX package and are permuted to NCHW inside. The
pyramids compute in the configured dtype (bf16 on the card) and return fp32.
Not ported yet: MultiViewHybridEncoder.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import DTYPES
from .layers import Conv2dLayer, FullyConnectedLayer, init_seeded

_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}


class EncoderResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = Conv2dLayer(in_channels, in_channels, 3, activation="lrelu")
        self.conv2 = Conv2dLayer(in_channels, out_channels, 3, down=2, activation="lrelu")
        self.skip = Conv2dLayer(in_channels, out_channels, 1, down=2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


class _Projector(nn.Module):
    """4x4 VALID conv on the 4^2 map, no bias (EqualConv2d, networks.py:1590)."""

    def __init__(self, in_channels: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_channels, 4, 4))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (1.0 / math.sqrt(self.weight.shape[1] * 16))
        return F.conv2d(x, w).reshape(x.shape[0], -1).float()  # [B, out_dim]


class _ConvPyramid(nn.Module):
    """1x1 stem + resblocks from `size` down to 4^2 + the projector:
    NCHW [B, input_dim, size, size] -> fp32 [B, out_dim]."""

    def __init__(self, size: int, input_dim: int, out_dim: int, dtype: str = "float32"):
        super().__init__()
        self.dtype = DTYPES[dtype]
        self.stem = Conv2dLayer(input_dim, _CHANNELS[size], 1)
        in_ch = _CHANNELS[size]
        self.num_blocks = int(math.log2(size)) - 2
        for i in range(self.num_blocks):
            out_ch = _CHANNELS[size >> (i + 1)]
            setattr(self, f"block{i}", EncoderResBlock(in_ch, out_ch))
            in_ch = out_ch
        self.projector = _Projector(in_ch, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x.to(self.dtype))
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return self.projector(x)


class Encoder(_ConvPyramid):
    """Single-stream encoder: NHWC x [B,R,R,input_dim] -> fp32 ws [B, n_latents, w_dim]."""

    def __init__(self, size: int, n_latents: int, w_dim: int = 512, input_dim: int = 3,
                 dtype: str = "float32"):
        super().__init__(size, input_dim, n_latents * w_dim, dtype)
        self.n_latents, self.w_dim = n_latents, w_dim

    def init(self, seed: int = 0) -> "Encoder":
        """Seeded weights (normal weights, zero biases), as Ide3dGenerator.init. Returns self."""
        return init_seeded(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = super().forward(x.permute(0, 3, 1, 2))
        return out.reshape(x.shape[0], self.n_latents, self.w_dim)


class HybridEncoder(nn.Module):
    """Dual-stream (image + seg) encoder:
    forward(img [B,R,R,3], seg [B,R,R,19]) -> fp32 ws [B, geo+app, w_dim],
    geometry (seg) rows first, to align with the generator's latent layout."""

    def __init__(self, size: int = 512, n_latents_app: int = 10, n_latents_geo: int = 8,
                 w_dim: int = 512, input_img_dim: int = 3, input_seg_dim: int = 19,
                 dtype: str = "float32"):
        super().__init__()
        self.n_latents_app, self.n_latents_geo, self.w_dim = n_latents_app, n_latents_geo, w_dim
        self.img = _ConvPyramid(size, input_img_dim, n_latents_app * w_dim, dtype)
        self.seg = _ConvPyramid(size, input_seg_dim, n_latents_geo * w_dim, dtype)

    def init(self, seed: int = 0) -> "HybridEncoder":
        """Seeded weights (normal weights, zero biases), as Ide3dGenerator.init. Returns self."""
        return init_seeded(self, seed)

    def forward(self, img: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        B = img.shape[0]
        out_img = self.img(img.permute(0, 3, 1, 2)).reshape(B, self.n_latents_app, self.w_dim)
        out_seg = self.seg(seg.permute(0, 3, 1, 2)).reshape(B, self.n_latents_geo, self.w_dim)
        return torch.cat([out_seg, out_img], dim=1)


class _MultiViewStream(nn.Module):
    """One stream of MultiViewHybridEncoder: the pyramid to the fused width
    (NCHW in) and the 4-layer MLP on the fused feature half."""

    def __init__(self, size: int, input_dim: int, n_latents: int, w_dim: int,
                 fusion_channels: int, dtype: str):
        super().__init__()
        self.pyramid = _ConvPyramid(size, input_dim, fusion_channels, dtype)
        dims = [fusion_channels // 2, 256, 256, 256, n_latents * w_dim]
        for i in range(4):
            setattr(self, f"fc{i}", FullyConnectedLayer(dims[i], dims[i + 1]))

    def mlp(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            h = getattr(self, f"fc{i}")(h)
        return h


class MultiViewHybridEncoder(nn.Module):
    """Multi-view variant with sigma-weighted fusion
    (contract: inversion/networks.py:1669-1773).

    forward(img [V*B,R,R,3], seg [V*B,R,R,19]) -> fp32 ws [B, geo+app, w_dim];
    views of one sample lie `batch` apart (networks.py:1766). Each pyramid
    output is split into (sigma, feature) halves; the features are fused
    across the `num_view` views weighted by sigma / sum over views (a zero sum
    reads 1e-4); a single view uses its feature half directly (:1740)."""

    def __init__(self, size: int = 512, n_latents_app: int = 10, n_latents_geo: int = 8,
                 w_dim: int = 512, input_img_dim: int = 3, input_seg_dim: int = 19,
                 num_view: int = 3, dtype: str = "float32", fusion_channels: int = 1024):
        super().__init__()
        self.n_latents_app, self.n_latents_geo, self.w_dim = n_latents_app, n_latents_geo, w_dim
        self.num_view = num_view
        self.img = _MultiViewStream(size, input_img_dim, n_latents_app, w_dim, fusion_channels, dtype)
        self.seg = _MultiViewStream(size, input_seg_dim, n_latents_geo, w_dim, fusion_channels, dtype)

    def init(self, seed: int = 0) -> "MultiViewHybridEncoder":
        """Seeded weights (normal weights, zero biases), as Ide3dGenerator.init. Returns self."""
        return init_seeded(self, seed)

    def _fuse(self, feats: torch.Tensor, batch: int) -> torch.Tensor:
        """[V*B, F] (sigma | feature) -> [B, F/2], sigma-weighted over the views."""
        F_ = feats.shape[-1]
        x = feats.reshape(self.num_view, batch, F_)
        sigma, feat = x[..., : F_ // 2], x[..., F_ // 2:]
        denom = sigma.sum(dim=0, keepdim=True)
        denom = torch.where(denom == 0, torch.full_like(denom, 1e-4), denom)
        return (feat * (sigma / denom)).sum(dim=0)

    def forward(self, img: torch.Tensor, seg: torch.Tensor,
                num_view: Optional[int] = None) -> torch.Tensor:
        V = self.num_view if num_view is None else num_view
        B = img.shape[0] // V
        outs = {}
        for name, x, nl in (("img", img, self.n_latents_app), ("seg", seg, self.n_latents_geo)):
            stream = getattr(self, name)
            feats = stream.pyramid(x.permute(0, 3, 1, 2))  # [V*B, fusion_channels]
            fused = self._fuse(feats, B) if V > 1 else feats[:, feats.shape[-1] // 2:]
            outs[name] = stream.mlp(fused).reshape(B, nl, self.w_dim)
        return torch.cat([outs["seg"], outs["img"]], dim=1)
