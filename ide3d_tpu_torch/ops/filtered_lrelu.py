"""Filtered leaky ReLU (the StyleGAN3 alias-free nonlinearity).

Counterpart of ide3d_tpu/ops/filtered_lrelu.py, in the same order: the bias,
the FIR upsample by `up` (gain up^2), the leaky ReLU with its gain and clamp,
then the FIR downsample by `down`, on NCHW images; `padding` is taken w.r.t.
the upsampled image. `filtered_lrelu` runs on the tensors' device:

  * on CUDA it launches the fused kernel (csrc/filtered_lrelu.cu, built by
    nvcc at first use) or raises; it never falls back. The kernel takes
    float32 and bfloat16, `up` 1, 2 or 4, `down` 1 or 2, and each filter
    absent or 1-D with 6 taps per factor (without filters at up = down = 1
    the padding must be 0): every call of the SG3 superres stack. It never
    writes the upsampled grid and accumulates in fp32. It is differentiable:
    `_FilteredLreluFn`'s backward recomputes the op through
    `filtered_lrelu_plain` and differentiates that (twice under
    create_graph), so training and inversion run the kernel forward;
  * on the CPU it runs `filtered_lrelu_plain`, the port's own bias_act and
    upfirdn2d, which autograd differentiates and which also takes radial
    (2-D) filters.

The forward is also the operator `torch.ops.ide3d_tpu_torch.filtered_lrelu`
(`OP`; CUDA: the kernel, CPU: `filtered_lrelu_plain`, and a fake
implementation that gives the output's shape). While torch.compile or
torch.export traces, `filtered_lrelu` goes through the operator on both
devices, so a traced program records the op as one node.

`filtered_lrelu.launches` counts the kernel's launches and
`filtered_lrelu.plain` the plain calls, since their last reset.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .. import _build
from .bias_act import bias_act
from .upfirdn2d import FilterArg, _parse_padding, upfirdn2d

UPS, DOWNS, TAPS_PER_FACTOR = (1, 2, 4), (1, 2), 6


def filtered_lrelu_plain(
    x: torch.Tensor,  # [N, C, H, W]
    fu: FilterArg = None,
    fd: FilterArg = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2.0),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    """The op from the port's bias_act and upfirdn2d, in x's dtype."""
    if x.ndim != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up**2, flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)


def _kernel_filter(f: FilterArg, factor: int, device) -> Optional[torch.Tensor]:
    """Filter f as the kernel takes it (None, or a contiguous fp32 tensor on
    `device` of 6 taps a factor); ValueError for any other filter."""
    if f is None:
        return None
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.ndim != 1 or f.numel() != TAPS_PER_FACTOR * factor:
        raise ValueError(f"filtered_lrelu on CUDA takes 1-D filters of {TAPS_PER_FACTOR} taps a "
                         f"factor (factor {factor}), got shape {tuple(f.shape)}")
    return f.contiguous()


def _kernel_args(x, fu, fd, b, up, down, padding) -> tuple:
    """(fu, fd) as the kernel takes them; ValueError where it cannot take the call."""
    if x.ndim != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"filtered_lrelu on CUDA takes float32 or bfloat16 NCHW input, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if up not in UPS or down not in DOWNS:
        raise ValueError(f"filtered_lrelu on CUDA takes up in {UPS} and down in {DOWNS}, got "
                         f"{up} and {down}")
    if b is not None and (b.ndim != 1 or b.shape[0] != x.shape[1] or b.device != x.device):
        raise ValueError(f"bias of shape {tuple(b.shape)} on {b.device} for input "
                         f"{tuple(x.shape)} on {x.device}")
    ku, kd = _kernel_filter(fu, up, x.device), _kernel_filter(fd, down, x.device)
    if up == down == 1 and ku is None and kd is None and any(padding):
        raise ValueError("filtered_lrelu on CUDA takes no padding without filters at up = down = 1")
    return ku, kd


def _out_size(x, fu, fd, up, down, padding) -> tuple[int, int]:
    px0, px1, py0, py1 = padding
    (tuy, tux), (tdy, tdx) = [(1, 1) if f is None else (f.shape[0], f.shape[-1]) for f in (fu, fd)]
    Hu, Wu = x.shape[2] * up + py0 + py1 - tuy + 1, x.shape[3] * up + px0 + px1 - tux + 1
    Ho, Wo = (Hu - tdy) // down + 1, (Wu - tdx) // down + 1
    if Ho <= 0 or Wo <= 0:
        raise ValueError(f"filtered_lrelu: no output pixels for input {tuple(x.shape)}, padding "
                         f"{padding}, filters {tux} / {tdx} taps")
    return Ho, Wo


@functools.cache
def _kernel_fn():
    fn = _build.load("filtered_lrelu").ide3d_filtered_lrelu
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, p, p, p, p] + [i] * 14 + [f, f, f, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, ku, kd, b, up, down, padding, gain, slope, clamp, flip_filter) -> torch.Tensor:
    """One launch of the kernel; `padding` is (px0, px1, py0, py1)."""
    N, C, H, W = x.shape
    Ho, Wo = _out_size(x, ku, kd, up, down, padding)
    x = x.contiguous()
    b = None if b is None else b.to(x.dtype).contiguous()
    out = torch.empty(N, C, Ho, Wo, device=x.device, dtype=x.dtype)
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    rc = _kernel_fn()(
        dev, x.data_ptr(), None if b is None else b.data_ptr(),
        None if ku is None else ku.data_ptr(), None if kd is None else kd.data_ptr(),
        out.data_ptr(), N, C, H, W, Ho, Wo, up, down, 1 if ku is None else ku.numel(),
        1 if kd is None else kd.numel(), padding[0], padding[2], int(flip_filter),
        int(x.dtype == torch.bfloat16), float(gain), float(slope),
        -1.0 if clamp is None else float(clamp), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: CUDA error {rc}")
    filtered_lrelu.launches += 1
    return out


@torch.library.custom_op(
    "ide3d_tpu_torch::filtered_lrelu", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor? fu, Tensor? fd, Tensor? b, int up, int down, int[] padding, "
           "float gain, float slope, float? clamp, bool flip_filter) -> Tensor")
def _filtered_lrelu_op(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
    """The op as an operator; on the CPU the plain version."""
    filtered_lrelu.plain += 1
    return filtered_lrelu_plain(x, fu, fd, b, up, down, list(padding), gain, slope, clamp,
                                flip_filter)


@_filtered_lrelu_op.register_kernel("cuda")
def _(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
    return _launch(x, fu, fd, b, up, down, tuple(padding), gain, slope, clamp, flip_filter)


@_filtered_lrelu_op.register_fake
def _(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
    return x.new_empty(x.shape[0], x.shape[1], *_out_size(x, fu, fd, up, down, tuple(padding)))


OP = torch.ops.ide3d_tpu_torch.filtered_lrelu.default


class _FilteredLreluFn(torch.autograd.Function):
    """The kernel's forward (the operator's while a compiler or exporter
    traces); the backward recomputes the op through `filtered_lrelu_plain`
    and differentiates it, with a graph under create_graph."""

    @staticmethod
    def forward(ctx, x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
        args = (up, down, padding, gain, slope, clamp, flip_filter)
        if torch.compiler.is_compiling():
            out = OP(x, fu, fd, b, up, down, list(padding), gain, slope, clamp, flip_filter)
        else:
            out = _launch(x, fu, fd, b, *args)
        ctx.save_for_backward(x, fu, fd, b)
        ctx.args = args
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:4]
        create = torch.is_grad_enabled()
        with torch.enable_grad():
            ins = [t if t is None or create else t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            y = filtered_lrelu_plain(*ins, *ctx.args)
            grads = iter(torch.autograd.grad(y, [t for t, need in zip(ins, needs) if need], g,
                                             create_graph=create))
        return (*(next(grads) if need else None for need in needs),) + (None,) * 7


def filtered_lrelu(
    x: torch.Tensor,  # [N, C, H, W]
    fu: FilterArg = None,
    fd: FilterArg = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = math.sqrt(2.0),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    """The op in x's dtype on x's device: the fused kernel on CUDA (or a
    ValueError for a call it does not take), the plain version on the CPU
    (see the module's docstring)."""
    if clamp is not None and clamp < 0:
        raise ValueError("clamp must be non-negative")
    padding = _parse_padding(padding)
    if x.device.type == "cpu":
        if not torch.compiler.is_compiling():
            filtered_lrelu.plain += 1
            return filtered_lrelu_plain(x, fu, fd, b, up, down, padding, gain, slope, clamp,
                                        flip_filter)
        fu, fd = [None if f is None else torch.as_tensor(f, dtype=torch.float32) for f in (fu, fd)]
    elif x.device.type == "cuda":
        fu, fd = _kernel_args(x, fu, fd, b, up, down, padding)
    else:
        raise NotImplementedError(f"filtered_lrelu has no kernel for {x.device}")
    return _FilteredLreluFn.apply(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter)


filtered_lrelu.launches = 0  # fused kernel launches since the last reset
filtered_lrelu.plain = 0  # plain calls since the last reset
