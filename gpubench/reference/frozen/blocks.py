"""Synthesis blocks: the 2D superresolution block and the dual-path tri-plane block.

Counterpart of ide3d_tpu/models/blocks.py:
  * `SynthesisBlock`: StyleGAN2 skip architecture, two modulated convs (the
    first upsamples unless up == 1) and an RGB skip branch upsampled with the
    FIR filter,
  * `SegSynthesisBlock` with its default interior: one w-consuming conv, dual
    ToRGB/ToSEG heads sharing one w row, and the texture path conditioned on
    the semantic planes (SPADE-style gamma/beta 1x1 convs); or, with
    `ref_compat=True`, the reference two-conv interior: conv0 (upsampling,
    absent in the first block), conv1, the ToRGB/ToSEG heads on one shared w
    row, skip planes upsampled with the FIR filter and the semantic planes
    not fed back. Its parameter names are the reference state dict's, and
    the JAX tree's, so imported checkpoints and io/from_jax both load it.

Blocks compute in a configurable dtype (bf16 on the card); the accumulated
plane and RGB skips stay fp32. Activations are NCHW.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .upfirdn2d import setup_filter, upsample2d
from .layers import CONV_CLAMP, RESAMPLE_FILTER, Conv2dLayer, SynthesisLayer, ToRGBLayer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SynthesisBlock(nn.Module):
    """Consumes ws rows (w_conv0, w_conv1, w_torgb)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, up: int = 2, dtype: str = "float32",
                 conv_clamp: Optional[float] = CONV_CLAMP):
        super().__init__()
        self.up = up
        self.dtype = DTYPES[dtype]
        self.register_buffer("resample_filter", setup_filter(RESAMPLE_FILTER), persistent=False)
        self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=up,
                                    conv_clamp=conv_clamp)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim, conv_clamp=conv_clamp)

    def forward(
        self,
        x: torch.Tensor,  # [B, in_channels, r/up, r/up]
        img: Optional[torch.Tensor],  # [B, img_channels, r/up, r/up] fp32 skip, or None
        ws3: torch.Tensor,  # [B, 3, w_dim]
        noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        x = self.conv0(x, ws3[:, 0], noise_mode=noise_mode, generator=generator)
        x = self.conv1(x, ws3[:, 1], noise_mode=noise_mode, generator=generator)
        if img is not None and self.up > 1:
            img = upsample2d(img, self.resample_filter, up=self.up)
        y = self.torgb(x, ws3[:, 2]).float()
        return x, (y if img is None else img + y)


class SegSynthesisBlock(nn.Module):
    """Dual-path tri-plane block `vb{res}`:
    forward(x, img_v, ws2, condition_img=seg_v_prev) -> (x, img_v, seg_v), with
      x      [B, C, r, r]       backbone features,
      img_v  [B, 3*Cf, r, r]    texture plane stack (fp32 skip),
      seg_v  [B, 3*Cs, r, r]    semantic plane stack (fp32 skip),
      ws2    [B, 2, w_dim]      (w_conv, w_planes); w_planes is the row shared
                                by the heads of all vb blocks. With ref_compat
                                [B, num_conv + 1, w_dim]: the convs' rows, then
                                the heads' row."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_plane_channels: int, seg_plane_channels: int, up: int = 2,
                 dtype: str = "float32", ref_compat: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.up = up
        self.dtype = DTYPES[dtype]
        self.ref_compat = ref_compat
        self.register_buffer("resample_filter", setup_filter(RESAMPLE_FILTER), persistent=False)
        if ref_compat:
            if in_channels:
                self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=up)
            self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution)
        else:
            self.conv = SynthesisLayer(in_channels if in_channels else out_channels, out_channels,
                                       w_dim, resolution, up=up if in_channels else 1)
        self.torgb = ToRGBLayer(out_channels, img_plane_channels, w_dim)
        self.toseg = ToRGBLayer(out_channels, seg_plane_channels, w_dim)
        if not ref_compat:
            self.spade_gamma = Conv2dLayer(seg_plane_channels, out_channels, 1)
            self.spade_beta = Conv2dLayer(seg_plane_channels, out_channels, 1)
        if in_channels == 0:
            self.const = nn.Parameter(torch.empty(out_channels, resolution, resolution))

    @property
    def num_conv(self) -> int:
        """w rows the convs consume (the reference's `num_conv`)."""
        if not self.ref_compat:
            return 1
        return 1 if self.in_channels == 0 else 2

    @property
    def num_ws_rows(self) -> int:
        """w rows the block reads: its convs' and the shared ToRGB/ToSEG row."""
        return self.num_conv + 1

    def init_parameters(self, generator: torch.Generator) -> None:
        if self.in_channels == 0:
            with torch.no_grad():
                self.const.normal_(generator=generator)

    def forward(
        self,
        x: Optional[torch.Tensor],
        img_v: Optional[torch.Tensor],
        ws2: torch.Tensor,
        condition_img: Optional[torch.Tensor] = None,  # previous seg_v planes
        noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self.ref_compat:
            return self._forward_ref(x, img_v, ws2, condition_img, noise_mode, generator)
        if self.in_channels == 0:
            x = self.const.to(self.dtype)[None].expand(ws2.shape[0], -1, -1, -1)
        else:
            x = x.to(self.dtype)
        x = self.conv(x, ws2[:, 0], noise_mode=noise_mode, generator=generator)

        if self.up > 1 and self.in_channels != 0:
            if img_v is not None:
                img_v = upsample2d(img_v, self.resample_filter, up=self.up)
            if condition_img is not None:
                condition_img = upsample2d(condition_img, self.resample_filter, up=self.up)

        # Semantic head first, on the unconditioned features.
        y_seg = self.toseg(x, ws2[:, 1]).float()
        seg_v = y_seg if condition_img is None else condition_img + y_seg

        # Texture head conditioned on the accumulated semantic planes.
        sv = seg_v.to(self.dtype)
        x_tex = x * (1.0 + self.spade_gamma(sv)) + self.spade_beta(sv)
        y_img = self.torgb(x_tex, ws2[:, 1]).float()
        img_v = y_img if img_v is None else img_v + y_img
        return x, img_v, seg_v

    def _forward_ref(
        self,
        x: Optional[torch.Tensor],
        img_v: Optional[torch.Tensor],
        ws: torch.Tensor,  # [B, num_conv + 1, w_dim]
        seg_v: Optional[torch.Tensor],
        noise_mode: str,
        generator: Optional[torch.Generator],
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The reference interior: conv0 (up) -> conv1 -> ToRGB/ToSEG on the
        shared row; the incoming planes are upsampled when the features are
        twice their size, and the semantic planes condition nothing."""
        wi = 0
        if self.in_channels == 0:
            x = self.const.to(self.dtype)[None].expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x.to(self.dtype), ws[:, 0], noise_mode=noise_mode, generator=generator)
            wi = 1
        x = self.conv1(x, ws[:, wi], noise_mode=noise_mode, generator=generator)
        w_shared = ws[:, wi + 1]
        if img_v is not None and img_v.shape[-1] * 2 == x.shape[-1]:
            img_v = upsample2d(img_v, self.resample_filter, up=2)
        if seg_v is not None and seg_v.shape[-1] * 2 == x.shape[-1]:
            seg_v = upsample2d(seg_v, self.resample_filter, up=2)
        y = self.torgb(x, w_shared).float()
        img_v = y if img_v is None else img_v + y
        y_seg = self.toseg(x, w_shared).float()
        seg_v = y_seg if seg_v is None else seg_v + y_seg
        return x, img_v, seg_v
