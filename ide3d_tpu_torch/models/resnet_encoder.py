"""ResNet18 global-feature image encoder.

Counterpart of ide3d_tpu/models/resnet_encoder.py (the reference's
inversion/networks.py:1779-1797, which no reference entry point builds): the
torchvision resnet18 trunk without its classifier (the stem, 4 layers and the
global average pool) on the input resized to 224² -> pooled [B, 512]. The
trunk is BiSeNet's (models/bisenet.Resnet18, torchvision tensor names), as the
JAX package reuses BiSeNet's. The resize is jax.image.resize's "cubic" (Keys'
a = -0.5, antialiased when it shrinks), which is F.interpolate's antialiased
bicubic both ways (the plain bicubic is a = -0.75). Images are NHWC.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from .arcface import draw_conv, reset_norms
from .bisenet import Resnet18


class ResNetEncoder(Resnet18):
    """forward(img [B, H, W, 3]) -> [B, 512] pooled resnet18 features."""

    input_size = 224

    @torch.no_grad()
    def init(self) -> "ResNetEncoder":
        """The JAX package's random init (numpy RandomState(0), in its order):
        convs N(0, 0.05²) drawn HWIO, identity BN. Returns self."""
        rs = np.random.RandomState(0)
        draw_conv(rs, self.conv1)
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                for c in (blk.conv1, blk.conv2) + ((blk.downsample[0],) if blk.downsample else ()):
                    draw_conv(rs, c)
        reset_norms(self)
        return self

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC -> NCHW at 224² (networks.py:1791-1793)."""
        x = x.permute(0, 3, 1, 2)
        if tuple(x.shape[2:]) == (self.input_size, self.input_size):
            return x
        return F.interpolate(x, size=(self.input_size, self.input_size), mode="bicubic",
                             align_corners=False, antialias=True)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        _, _, feat32 = super().forward(self.preprocess(img))
        return feat32.mean(dim=(2, 3))


def import_resnet_encoder(path: str, device: Union[torch.device, str] = "cuda") -> ResNetEncoder:
    """A torchvision resnet18 state dict (.pth) -> ResNetEncoder on `device`,
    in eval mode. The file is read by the port's stub reader (no pickled code
    runs); the `fc.*` head and the BN counters are not used, and a tensor the
    trunk needs and the file lacks raises."""
    from ..io.torch_import import load_torch_state_dict

    sd = load_torch_state_dict(path)
    enc = ResNetEncoder()
    own = enc.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path}: no tensor for {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    enc.load_state_dict({k: sd[k] for k in own})
    return enc.to(device).eval()
