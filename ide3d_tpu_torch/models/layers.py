"""Base layer family (StyleGAN2 conventions) as nn.Modules.

Counterpart of ide3d_tpu/models/layers.py: FullyConnectedLayer, Conv2dLayer
(the full contract: bias or none, activation, FIR up/down, clamp),
SynthesisLayer ('default' upsample mode) and ToRGBLayer, with the settings the
generator uses (3x3 modulated convs with noise, lrelu and conv clamp 256, or no
clamp for the TF1-era StyleGAN2 generator; 1x1 ToRGB). Parameters are stored
unit-variance in fp32 and scaled by the equalized-lr gains at call time, then
cast to the activations' dtype. Layouts: activations NCHW, conv weights OIHW,
FC weights [out, in] (the JAX package: NHWC, HWIO, [in, out]; io/from_jax.py
converts). Every module with parameters has `init_parameters(generator)`,
which draws them as the JAX `init` does (normal weights, constant biases).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.modulated_conv import modulated_conv2d
from ..ops.upfirdn2d import setup_filter
from ..parallel.mesh import draw

RESAMPLE_FILTER = (1, 3, 3, 1)
CONV_CLAMP = 256.0
LRELU_GAIN = math.sqrt(2.0)


class FullyConnectedLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias_init: float = 0.0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator).div_(self.lr_multiplier)
            self.bias.fill_(float(self.bias_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gain = self.lr_multiplier / math.sqrt(self.in_features)
        x = x @ (self.weight.to(x.dtype) * gain).t()
        b = self.bias * self.lr_multiplier if self.lr_multiplier != 1 else self.bias
        return bias_act(x, b.to(x.dtype), dim=-1, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-lr conv with optional bias, FIR up/downsampling by `up`/`down`,
    bias + activation (the activation's gain times `gain`) and an optional clamp
    (`conv_clamp * gain`). Without a bias the module has no `bias` parameter,
    as the JAX tree has no `bias` leaf."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = True,
                 activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter=RESAMPLE_FILTER, conv_clamp: Optional[float] = None):
        super().__init__()
        self.in_channels, self.kernel_size = in_channels, kernel_size
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.register_buffer("resample_filter",
                             setup_filter(resample_filter) if up > 1 or down > 1 else None,
                             persistent=False)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (1.0 / math.sqrt(self.in_channels * self.kernel_size**2))
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up, down=self.down,
                            padding=self.kernel_size // 2, flip_weight=(self.up == 1))
        return bias_act(x, None if self.bias is None else self.bias.to(x.dtype),
                        act=self.activation, gain=activation_funcs[self.activation].def_gain * gain,
                        clamp=None if self.conv_clamp is None else self.conv_clamp * gain)


class SynthesisLayer(nn.Module):
    """Modulated 3x3 conv + noise + bias/lrelu/clamp; the style affine is part of the layer."""

    kernel_size = 3

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int, up: int = 1,
                 conv_clamp: Optional[float] = CONV_CLAMP):
        super().__init__()
        self.resolution = resolution
        self.up = up
        self.conv_clamp = conv_clamp
        self.register_buffer("resample_filter", setup_filter(RESAMPLE_FILTER), persistent=False)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        k = self.kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.noise_const = nn.Parameter(torch.empty(resolution, resolution))
        self.noise_strength = nn.Parameter(torch.zeros(()))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            self.bias.zero_()
            self.noise_const.normal_(generator=generator)
            self.noise_strength.zero_()

    def forward(
        self,
        x: torch.Tensor,
        w: torch.Tensor,  # [B, w_dim]
        noise_mode: str = "const",  # 'random' | 'const' | 'none'
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"noise_mode must be random, const or none, got {noise_mode!r}")
        styles = self.affine(w.float())

        noise = None
        if noise_mode == "random":
            if generator is None:
                raise ValueError("noise_mode='random' needs a torch.Generator")
            noise = draw(torch.randn, (x.shape[0], 1, self.resolution, self.resolution),
                         generator=generator, device=x.device) * self.noise_strength
        elif noise_mode == "const":
            noise = (self.noise_const * self.noise_strength)[None, None]

        x = modulated_conv2d(
            x, self.weight.to(x.dtype), styles, noise=noise, up=self.up,
            padding=self.kernel_size // 2,
            resample_filter=self.resample_filter if self.up > 1 else None,
            flip_weight=(self.up == 1),
        )
        return bias_act(x, self.bias.to(x.dtype), act="lrelu", gain=LRELU_GAIN, clamp=self.conv_clamp)


class ToRGBLayer(nn.Module):
    """Style-modulated 1x1 projection without demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 conv_clamp: Optional[float] = CONV_CLAMP):
        super().__init__()
        self.in_channels = in_channels
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w.float()) * (1.0 / math.sqrt(self.in_channels))
        x = modulated_conv2d(x, self.weight.to(x.dtype), styles, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


def init_module(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` from `generator`, module by module in
    registration order."""
    for m in module.modules():
        init = getattr(m, "init_parameters", None)
        if init is not None:
            init(generator)


def init_seeded(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of `module` from a CPU torch.Generator seeded with
    `seed`, so the same seed gives the same weights on every device; the module
    stays on its device. Returns the module."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dev = next(module.parameters()).device
    module.to("cpu")
    init_module(module, gen)
    return module.to(dev)
