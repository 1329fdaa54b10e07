"""LPIPS perceptual distance: VGG16 taps + learned per-channel weights.

Counterpart of ide3d_tpu/metrics/lpips.py:

    d(x, y) = sum_l  mean_hw  sum_c  w_l[c] * (phi_l(x)^ - phi_l(y)^)[c]^2

with channel-normalised activations phi^ at the five VGG16 relu taps. The
input goes through the LPIPS scaling layer (x - shift) / scale and into the
trunk through v / 127.5 - 1 (VGG16Features.feature_maps applies (v + 1) * 127.5).
`lin{i}.weight` keeps the JAX layout (C,), so io/from_jax bridges a JAX LPIPS
tree (`vgg` + `lin0..lin4`) as it is. The weights come from such a tree or a
state dict (`load_state_dict`); the module is built without them, and
`init()` gives the uncalibrated distance of the JAX package's `LPIPS.init`.
"""

from __future__ import annotations

import torch
from torch import nn

from .features import VGG16Features

# channel widths at the 5 LPIPS tap points of VGG16
_TAP_CHANNELS = (64, 128, 256, 512, 512)

# ImageNet normalization baked into the official LPIPS ("scaling layer")
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _ChannelWeight(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c))


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(_TAP_CHANNELS):
            setattr(self, f"lin{i}", _ChannelWeight(c))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    @torch.no_grad()
    def init(self) -> "LPIPS":
        """The JAX package's VGG16 init (numpy RandomState(0), the same trunk)
        and lin weights |N(0, 1)| * 0.1 drawn from a CPU torch.Generator seeded
        0 (the JAX package draws them from jax.random, so they differ).
        Returns self."""
        self.vgg.init()
        gen = torch.Generator().manual_seed(0)
        for i in range(len(_TAP_CHANNELS)):
            w = getattr(self, f"lin{i}").weight
            w.copy_(torch.randn(w.shape, generator=gen).abs() * 0.1)
        return self

    def _taps(self, x: torch.Tensor) -> list:
        v = (x - self.shift.to(x.dtype)) / self.scale.to(x.dtype)
        return self.vgg.feature_maps(v / 127.5 - 1.0)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y [B, H, W, 3] in [-1, 1] -> distances [B]."""
        total = 0.0
        for i, (a, b) in enumerate(zip(self._taps(x), self._taps(y))):
            a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").weight
            d = (a - b).square() * w[: a.shape[-1]]
            total = total + d.sum(dim=-1).mean(dim=(1, 2))
        return total

    def mean(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self(x, y).mean()
