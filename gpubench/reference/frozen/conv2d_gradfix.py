"""2-D convolution whose gradient is made of plain convolutions, so that it
differentiates twice at the cost of once.

PyTorch's double backward of a convolution (`_convolution_double_backward`)
runs one small convolution per group for a grouped convolution: the
depthwise FIR filters of `upfirdn2d` (one group per channel) made an R1 step
of the flagship D take 15.4 s of device time on the H100 against 0.24 s for a
step without R1 (tools/profile_torch_train.py). Here a convolution is an
autograd Function whose input gradient is `F.conv_transpose2d` of the output
gradient and whose weight gradient is `aten.convolution_backward`: R1's second
pass then differentiates ordinary (transposed) convolutions once. The forward
is `F.conv2d` as it is. Counterpart of the reference's conv2d_gradfix; the
JAX package needs none, as XLA differentiates a convolution to any order.

`no_weight_gradients()` skips the weight gradients inside it: R1's first
pass wants the input gradient only.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_weight_gradients = True
QUANT = None  # when set, rounds the operands of every convolution and of its gradients (straight through)


@contextlib.contextmanager
def no_weight_gradients():
    """Inside: the backward of `conv2d` returns no weight gradient."""
    global _weight_gradients
    old, _weight_gradients = _weight_gradients, False
    try:
        yield
    finally:
        _weight_gradients = old


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return F.conv2d(x, w, None, stride, padding, 1, groups)

    @staticmethod
    def backward(ctx, g):
        if QUANT is not None:
            g = g + (QUANT(g) - g).detach()
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            out_pad = [x.shape[i + 2] - ((g.shape[i + 2] - 1) * stride[i] - 2 * padding[i] + w.shape[i + 2])
                       for i in range(2)]
            gx = F.conv_transpose2d(g, w, None, stride, padding, out_pad, groups)
        if ctx.needs_input_grad[1] and _weight_gradients:
            gw = torch.ops.aten.convolution_backward(
                g, x, w, None, stride, padding, (1, 1), False, (0, 0), groups,
                (False, True, False))[1]
        return gx, gw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0, groups: int = 1) -> torch.Tensor:
    """F.conv2d(x, w, stride=stride, padding=padding, groups=groups), no bias or
    dilation; F.conv2d itself when no gradient is wanted (inference)."""
    if QUANT is not None:
        x = x + (QUANT(x) - x).detach()
        w = w + (QUANT(w) - w).detach()
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return F.conv2d(x, w, None, stride, padding, 1, groups)
    return _Conv2d.apply(x, w, _pair(stride), _pair(padding), groups)
