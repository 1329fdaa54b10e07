"""Fused bias + activation (+ gain + clamp), plain PyTorch.

Counterpart of ide3d_tpu/ops/bias_act.py: the same activation table with its
default alphas and gains (StyleGAN2's sqrt(2) lrelu gain etc.) and the same
add-bias -> act -> gain -> clamp order. PyTorch's eager ops run it; the bias
axis defaults to 1 (NCHW), as in the upstream torch op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2.0)),
    "lrelu": ActivationSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2.0)),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2.0)),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add bias `b` along `dim`, apply `act`, scale by `gain`, clamp to ±`clamp`.

    `gain`/`alpha` default to the activation's spec values; `clamp=None`
    disables clamping. Computes and returns in x.dtype.
    """
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)

    if b is not None:
        if b.ndim != 1:
            raise ValueError(f"bias must be 1-D, got shape {tuple(b.shape)}")
        d = dim % x.ndim
        if b.shape[0] != x.shape[d]:
            raise ValueError(f"bias dim {b.shape[0]} != x.shape[{d}] = {x.shape[d]}")
        shape = [1] * x.ndim
        shape[d] = -1
        x = x + b.to(x.dtype).reshape(shape)

    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        if clamp < 0:
            raise ValueError("clamp must be non-negative")
        x = x.clamp(-clamp, clamp)
    return x
