"""K1: depth sort + alpha compositing of the merged coarse and fine samples.

Counterpart of `sort_integrate_pallas` (ide3d_tpu/ops/pallas/ray_march.py), the
JAX package's TPU kernel, with the options of the fine composite
`integrate_rays_merged` (ide3d_tpu/render/integration.py): density noise,
softplus or relu clamp, last_back and white_back. `sort_integrate` is the
entry point:

  * on CUDA tensors it launches the hand-written kernel in csrc/ray_march.cu
    (built by nvcc at first use) or raises; it never falls back. It is
    differentiable in the values: `_SortIntegrateFn`'s backward launches the
    hand-written backward kernel (`sort_integrate_backward`) through
    `_SortIntegrateBackwardFn`, whose own backward launches the hand-written
    double backward (`sort_integrate_double_backward`), so that a
    `create_graph` pass (path-length regularization) differentiates K1 twice;
    a third derivative raises,
  * on CPU tensors it runs `sort_integrate_plain`, the plain PyTorch version
    with the kernel's semantics, and autograd differentiates that.

The forward is also the operator `torch.ops.ide3d_tpu_torch.sort_integrate`
(`OP`; CUDA: the kernel's launch, CPU: `sort_integrate_plain`, and a fake
implementation that gives the outputs' shapes). While `torch.export` traces
(io/export.py), `sort_integrate` goes through the operator on both devices,
so an exported program records K1 as one node and runs the kernel, or on the
CPU the plain version, when it is called. The eager card path launches the
kernel directly: the operator's dispatch costs host time a call. Importing
this module registers the operator; a loaded program needs it.

The samples come as two halves (the coarse and the fine pass), so the merged
tensor is never written; the halves' depths need not be sorted or disjoint.
Semantics: stable depth sort (ties by index, the first half before the
second), delta = (z_next - z) * |ray_d| with a last delta of 1e10 * |ray_d|,
density = clamp(sigma + noise), alpha = 1 - exp(-delta * density),
transmittance exp(sum_{j<k} -delta_j density_j) from the analytic
log(1 - alpha). last_back adds 1 - sum(w) to the depth-order last weight
(weights_sum is then the adjusted sum); white_back adds 1 - sum(w), the sum
before last_back, to the features. `integrate_rays_merged`
(render/integration.py) floors each log(1 - alpha) at log(1e-10); K1 does not.
The two differ only behind a sample whose alpha is within 1e-10 of 1, where
the transmittance is below 1e-10 either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

MAX_SAMPLES = 256  # samples per ray, and channels C+1, the kernel takes
LAST_DELTA = 1e10
CLAMP_MODES = ("softplus", "relu")


def sort_integrate_plain(
    z_a: torch.Tensor,  # [B, R, Sa, 1] depths of the first half
    vals_a: torch.Tensor,  # [B, R, Sa, C+1] features ++ sigma
    z_b: torch.Tensor,  # [B, R, Sb, 1]
    vals_b: torch.Tensor,  # [B, R, Sb, C+1]
    ray_norm: torch.Tensor,  # [B, R, 1] |ray_d|
    noise: Optional[torch.Tensor] = None,  # [B, R, Sa+Sb] added to sigma, input order
    clamp_mode: str = "softplus",
    last_back: bool = False,
    white_back: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: sort + cumulative-sum compositing, in fp32.

    Returns (features [B,R,C], depth [B,R,1], weights_sum [B,R,1])."""
    z = torch.cat([z_a, z_b], dim=-2)[..., 0].float()  # [B,R,S]
    vals = torch.cat([vals_a, vals_b], dim=-2)  # [B,R,S,C+1]
    zs, order = torch.sort(z, dim=-1, stable=True)
    sigma = vals[..., -1].float()
    if noise is not None:
        sigma = sigma + noise.float()
    sigma = torch.gather(sigma, -1, order)
    if clamp_mode == "softplus":
        density = F.softplus(sigma)
    elif clamp_mode == "relu":
        density = F.relu(sigma)
    else:
        raise ValueError(f"clamp_mode must be one of {CLAMP_MODES}, got {clamp_mode!r}")
    nxt = torch.cat([zs[..., 1:], zs[..., -1:]], dim=-1)
    last = torch.zeros_like(zs, dtype=torch.bool)
    last[..., -1] = True
    deltas = torch.where(last, torch.full_like(zs, LAST_DELTA), nxt - zs) * ray_norm.float()
    x = deltas * density
    alphas = 1.0 - torch.exp(-x)
    # exclusive cumulative sum: the last (1e10) term never enters a transmittance
    log_t = torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(-x[..., :-1], dim=-1)], dim=-1)
    w_sorted = alphas * torch.exp(log_t)
    weights_sum = w_sorted.sum(-1, keepdim=True)
    if last_back:
        w_sorted = torch.cat([w_sorted[..., :-1], w_sorted[..., -1:] + 1.0 - weights_sum], dim=-1)
    w = torch.empty_like(w_sorted).scatter_(-1, order, w_sorted)  # back to input order
    feat = torch.einsum("brs,brsc->brc", w, vals[..., :-1].float())
    depth = (w_sorted * zs).sum(-1, keepdim=True)
    if white_back:
        feat = feat + (1.0 - weights_sum)
    return feat, depth, w_sorted.sum(-1, keepdim=True)


def _check(z_a, vals_a, z_b, vals_b, ray_norm, noise=None, clamp_mode="softplus") -> None:
    tensors = {"z_a": z_a, "vals_a": vals_a, "z_b": z_b, "vals_b": vals_b, "ray_norm": ray_norm}
    if noise is not None:
        tensors["noise"] = noise
    dev = z_a.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, z_a on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("z_a", "z_b", "ray_norm", "noise"):
        if name in tensors and tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    if vals_a.dtype not in (torch.float32, torch.bfloat16) or vals_b.dtype != vals_a.dtype:
        raise TypeError(f"vals must both be float32 or both bfloat16, got "
                        f"{vals_a.dtype}, {vals_b.dtype}")
    if clamp_mode not in CLAMP_MODES:
        raise ValueError(f"clamp_mode must be one of {CLAMP_MODES}, got {clamp_mode!r}")
    B, R, s_a, one = z_a.shape
    s_b = z_b.shape[2]
    c1 = vals_a.shape[-1]
    if (one != 1 or tuple(z_b.shape) != (B, R, s_b, 1)
            or tuple(vals_a.shape) != (B, R, s_a, c1) or tuple(vals_b.shape) != (B, R, s_b, c1)
            or tuple(ray_norm.shape) != (B, R, 1)
            or (noise is not None and tuple(noise.shape) != (B, R, s_a + s_b))):
        raise ValueError(
            "expected z [B,R,S,1], vals [B,R,S,C+1], ray_norm [B,R,1], noise [B,R,Sa+Sb]; "
            f"got {[tuple(t.shape) for t in tensors.values()]}")
    if B * R == 0 or s_a < 1 or s_b < 1 or s_a + s_b > MAX_SAMPLES:
        raise ValueError(f"need B*R > 0, 1 <= each half, Sa + Sb <= {MAX_SAMPLES}; "
                         f"got B={B}, R={R}, Sa={s_a}, Sb={s_b}")
    if not 2 <= c1 <= MAX_SAMPLES:
        raise ValueError(f"need 2 <= C+1 <= {MAX_SAMPLES} channels, got {c1}")


def sort_integrate_backward_plain(
    z_a: torch.Tensor,
    vals_a: torch.Tensor,
    z_b: torch.Tensor,
    vals_b: torch.Tensor,
    ray_norm: torch.Tensor,
    g_feat: torch.Tensor,  # [B, R, C] cotangents of the three outputs
    g_depth: torch.Tensor,  # [B, R, 1]
    g_wsum: torch.Tensor,  # [B, R, 1]
    noise: Optional[torch.Tensor] = None,
    clamp_mode: str = "softplus",
    last_back: bool = False,
    white_back: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1 backward: autograd through `sort_integrate_plain`. Returns the
    gradients (vals_a, vals_b) in the values' dtype."""
    with torch.enable_grad():
        va = vals_a.detach().requires_grad_()
        vb = vals_b.detach().requires_grad_()
        outs = sort_integrate_plain(z_a, va, z_b, vb, ray_norm, noise=noise,
                                    clamp_mode=clamp_mode, last_back=last_back,
                                    white_back=white_back)
        ga, gb = torch.autograd.grad(outs, (va, vb), (g_feat, g_depth, g_wsum))
    return ga, gb


def sort_integrate_double_backward_plain(
    z_a: torch.Tensor,
    vals_a: torch.Tensor,
    z_b: torch.Tensor,
    vals_b: torch.Tensor,
    ray_norm: torch.Tensor,
    g_feat: torch.Tensor,
    g_depth: torch.Tensor,
    g_wsum: torch.Tensor,
    gg_a: torch.Tensor,  # cotangents of the backward's two outputs, in the values' dtype
    gg_b: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    clamp_mode: str = "softplus",
    last_back: bool = False,
    white_back: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain K1 double backward: autograd with create_graph through
    `sort_integrate_plain`. Returns the gradients of <(gg_a, gg_b), K1's
    backward> with respect to (vals_a, vals_b) in their dtype and to
    (g_feat, g_depth, g_wsum) in fp32."""
    with torch.enable_grad():
        va = vals_a.detach().requires_grad_()
        vb = vals_b.detach().requires_grad_()
        gs = [g.detach().float().requires_grad_() for g in (g_feat, g_depth, g_wsum)]
        outs = sort_integrate_plain(z_a, va, z_b, vb, ray_norm, noise=noise,
                                    clamp_mode=clamp_mode, last_back=last_back,
                                    white_back=white_back)
        ga, gb = torch.autograd.grad(outs, (va, vb), gs, create_graph=True)
        res = torch.autograd.grad((ga, gb), (va, vb, *gs), (gg_a, gg_b), allow_unused=True)
    return tuple(torch.zeros_like(x) if r is None else r for r, x in zip(res, (va, vb, *gs)))


@functools.cache
def _kernel_fns():
    lib = _build.load("ray_march")
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd, bwd = lib.ide3d_sort_integrate, lib.ide3d_sort_integrate_backward
    dbl = lib.ide3d_sort_integrate_double_backward
    fwd.argtypes = [i, p, p, i, p, p, i, p, p, i, i, i, i, i, i, p, p, p, p]
    bwd.argtypes = [i, p, p, i, p, p, i, p, p, i, i, i, i, i, i, p, p, p, p, p, p]
    dbl.argtypes = [i, p, p, i, p, p, i, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p]
    fwd.restype = bwd.restype = dbl.restype = ctypes.c_int
    return fwd, bwd, dbl


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _launch_forward(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode, last_back, white_back):
    _check(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode)
    B, R, s_a, _ = z_a.shape
    s_b = z_b.shape[2]
    c1 = vals_a.shape[-1]
    dev = z_a.device
    feat = torch.empty(B, R, c1 - 1, device=dev, dtype=torch.float32)
    depth = torch.empty(B, R, 1, device=dev, dtype=torch.float32)
    wsum = torch.empty(B, R, 1, device=dev, dtype=torch.float32)
    rc = _kernel_fns()[0](
        _device_index(dev),
        z_a.data_ptr(), vals_a.data_ptr(), s_a, z_b.data_ptr(), vals_b.data_ptr(), s_b,
        ray_norm.data_ptr(), noise.data_ptr() if noise is not None else None, B * R, c1,
        int(vals_a.dtype == torch.bfloat16), int(clamp_mode == "relu"), int(last_back),
        int(white_back), feat.data_ptr(), depth.data_ptr(), wsum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ray_march kernel launch failed: CUDA error {rc}")
    sort_integrate.launches += 1
    return feat, depth, wsum


@torch.library.custom_op(
    "ide3d_tpu_torch::sort_integrate", mutates_args=(), device_types="cpu",
    schema="(Tensor z_a, Tensor vals_a, Tensor z_b, Tensor vals_b, Tensor ray_norm, "
           "Tensor? noise, str clamp_mode, bool last_back, bool white_back) "
           "-> (Tensor, Tensor, Tensor)")
def _sort_integrate_op(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode, last_back,
                       white_back):
    """K1's forward as an operator; on the CPU the plain version."""
    return sort_integrate_plain(z_a, vals_a, z_b, vals_b, ray_norm, noise=noise,
                                clamp_mode=clamp_mode, last_back=last_back, white_back=white_back)


_sort_integrate_op.register_kernel("cuda")(_launch_forward)


@_sort_integrate_op.register_fake
def _(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode, last_back, white_back):
    _check(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode)
    B, R, _, c1 = vals_a.shape
    return (z_a.new_empty(B, R, c1 - 1), z_a.new_empty(B, R, 1), z_a.new_empty(B, R, 1))


OP = torch.ops.ide3d_tpu_torch.sort_integrate.default


def _check_cotangents(vals_a, g_feat, g_depth, g_wsum) -> None:
    B, R, _, c1 = vals_a.shape
    dev = vals_a.device
    for name, g, shape in (("g_feat", g_feat, (B, R, c1 - 1)), ("g_depth", g_depth, (B, R, 1)),
                           ("g_wsum", g_wsum, (B, R, 1))):
        if g.device != dev or g.dtype != torch.float32 or tuple(g.shape) != shape \
                or not g.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on {dev}, got "
                             f"{g.dtype} {tuple(g.shape)} on {g.device}")


def sort_integrate_backward(
    z_a: torch.Tensor,
    vals_a: torch.Tensor,
    z_b: torch.Tensor,
    vals_b: torch.Tensor,
    ray_norm: torch.Tensor,
    g_feat: torch.Tensor,
    g_depth: torch.Tensor,
    g_wsum: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    clamp_mode: str = "softplus",
    last_back: bool = False,
    white_back: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's backward on the tensors' device: the CUDA kernel on CUDA, autograd
    through the plain version on the CPU. The cotangents are fp32 [B,R,C],
    [B,R,1], [B,R,1]; returns the gradients of (vals_a, vals_b) in their dtype."""
    if z_a.device.type == "cpu":
        return sort_integrate_backward_plain(z_a, vals_a, z_b, vals_b, ray_norm, g_feat, g_depth,
                                             g_wsum, noise=noise, clamp_mode=clamp_mode,
                                             last_back=last_back, white_back=white_back)
    if z_a.device.type != "cuda":
        raise NotImplementedError(f"sort_integrate_backward has no kernel for {z_a.device}")
    _check(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode)
    _check_cotangents(vals_a, g_feat, g_depth, g_wsum)
    B, R, s_a, _ = z_a.shape
    s_b = z_b.shape[2]
    c1 = vals_a.shape[-1]
    dev = z_a.device
    grad_a, grad_b = torch.empty_like(vals_a), torch.empty_like(vals_b)
    rc = _kernel_fns()[1](
        _device_index(dev),
        z_a.data_ptr(), vals_a.data_ptr(), s_a, z_b.data_ptr(), vals_b.data_ptr(), s_b,
        ray_norm.data_ptr(), noise.data_ptr() if noise is not None else None, B * R, c1,
        int(vals_a.dtype == torch.bfloat16), int(clamp_mode == "relu"), int(last_back),
        int(white_back), g_feat.data_ptr(), g_depth.data_ptr(), g_wsum.data_ptr(),
        grad_a.data_ptr(), grad_b.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ray_march backward kernel launch failed: CUDA error {rc}")
    sort_integrate_backward.launches += 1
    return grad_a, grad_b


sort_integrate_backward.launches = 0  # kernel launches since the last reset


def sort_integrate_double_backward(
    z_a: torch.Tensor,
    vals_a: torch.Tensor,
    z_b: torch.Tensor,
    vals_b: torch.Tensor,
    ray_norm: torch.Tensor,
    g_feat: torch.Tensor,
    g_depth: torch.Tensor,
    g_wsum: torch.Tensor,
    gg_a: torch.Tensor,
    gg_b: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    clamp_mode: str = "softplus",
    last_back: bool = False,
    white_back: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """K1's double backward on the tensors' device: the CUDA kernel on CUDA,
    autograd through the plain version on the CPU. gg_a, gg_b are the
    cotangents of the backward's gradients (the values' dtype and shapes);
    returns the gradients of (vals_a, vals_b) in their dtype and of (g_feat,
    g_depth, g_wsum) in fp32."""
    if z_a.device.type == "cpu":
        return sort_integrate_double_backward_plain(
            z_a, vals_a, z_b, vals_b, ray_norm, g_feat, g_depth, g_wsum, gg_a, gg_b, noise=noise,
            clamp_mode=clamp_mode, last_back=last_back, white_back=white_back)
    if z_a.device.type != "cuda":
        raise NotImplementedError(f"sort_integrate_double_backward has no kernel for {z_a.device}")
    _check(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode)
    _check_cotangents(vals_a, g_feat, g_depth, g_wsum)
    for name, gg, v in (("gg_a", gg_a, vals_a), ("gg_b", gg_b, vals_b)):
        if gg.device != v.device or gg.dtype != v.dtype or gg.shape != v.shape \
                or not gg.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {v.dtype} {tuple(v.shape)} tensor on "
                             f"{v.device}, got {gg.dtype} {tuple(gg.shape)} on {gg.device}")
    B, R, s_a, _ = z_a.shape
    s_b = z_b.shape[2]
    c1 = vals_a.shape[-1]
    dev = z_a.device
    d_a, d_b = torch.empty_like(vals_a), torch.empty_like(vals_b)
    d_gf, d_gd, d_gw = torch.empty_like(g_feat), torch.empty_like(g_depth), torch.empty_like(g_wsum)
    rc = _kernel_fns()[2](
        _device_index(dev),
        z_a.data_ptr(), vals_a.data_ptr(), s_a, z_b.data_ptr(), vals_b.data_ptr(), s_b,
        ray_norm.data_ptr(), noise.data_ptr() if noise is not None else None, B * R, c1,
        int(vals_a.dtype == torch.bfloat16), int(clamp_mode == "relu"), int(last_back),
        int(white_back), g_feat.data_ptr(), g_depth.data_ptr(), g_wsum.data_ptr(),
        gg_a.data_ptr(), gg_b.data_ptr(), d_a.data_ptr(), d_b.data_ptr(), d_gf.data_ptr(),
        d_gd.data_ptr(), d_gw.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ray_march double backward kernel launch failed: CUDA error {rc}")
    sort_integrate_double_backward.launches += 1
    return d_a, d_b, d_gf, d_gd, d_gw


sort_integrate_double_backward.launches = 0  # kernel launches since the last reset

DOUBLE_BACKWARD_PLANS = ("streamed", "staged")  # by the C++'s plan code


@functools.cache
def _plan_fn():
    fn = _build.load("ray_march").ide3d_sort_integrate_double_backward_plan
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, i, p, i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def double_backward_plan(z_a, vals_a, z_b, vals_b, ray_norm, g_feat, g_depth, g_wsum, gg_a, gg_b,
                         noise=None, **options) -> str:
    """The launch plan that `sort_integrate_double_backward` takes for these
    CUDA arguments (the same ones), as the kernel's C++ makes it from the
    shapes and the pointers' alignment: "staged" (TMA-staged rays) or
    "streamed" (the slabs read from device memory). Launches nothing; builds
    the kernel library at first use."""
    code = _plan_fn()(
        z_a.data_ptr(), vals_a.data_ptr(), z_a.shape[2], z_b.data_ptr(), vals_b.data_ptr(),
        z_b.shape[2], noise.data_ptr() if noise is not None else None, vals_a.shape[-1],
        int(vals_a.dtype == torch.bfloat16), gg_a.data_ptr(), gg_b.data_ptr())
    return DOUBLE_BACKWARD_PLANS[code]


class _SortIntegrateBackwardFn(torch.autograd.Function):
    """K1's backward as a differentiable function of the values and the
    cotangents: its forward launches the backward kernel, its backward the
    double backward kernel. It differentiates once: a third derivative of K1
    raises."""

    @staticmethod
    def forward(ctx, z_a, vals_a, z_b, vals_b, ray_norm, noise, g_feat, g_depth, g_wsum, opts):
        ctx.save_for_backward(z_a, vals_a, z_b, vals_b, ray_norm, noise, g_feat, g_depth, g_wsum)
        ctx.opts = opts
        return sort_integrate_backward(z_a, vals_a, z_b, vals_b, ray_norm, g_feat, g_depth, g_wsum,
                                       noise=noise, **opts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gg_a, gg_b):
        z_a, vals_a, z_b, vals_b, ray_norm, noise, g_feat, g_depth, g_wsum = ctx.saved_tensors
        gg = [torch.zeros_like(v) if g is None else g.to(v.dtype).contiguous()
              for g, v in ((gg_a, vals_a), (gg_b, vals_b))]
        d_a, d_b, d_gf, d_gd, d_gw = sort_integrate_double_backward(
            z_a, vals_a, z_b, vals_b, ray_norm, g_feat, g_depth, g_wsum, *gg, noise=noise,
            **ctx.opts)
        return None, d_a, None, d_b, None, None, d_gf, d_gd, d_gw, None


class _SortIntegrateFn(torch.autograd.Function):
    """K1 on the card with its hand-written backward (and on either device
    while `torch.export` traces, its forward then K1's operator): gradients
    for the two value slabs only, differentiable once more
    (`_SortIntegrateBackwardFn`).
    The depths, |ray_d| and the noise are constants of the composite (the JAX
    render stop-gradients its importance depths)."""

    @staticmethod
    def forward(ctx, z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode, last_back, white_back):
        needs = ctx.needs_input_grad
        for name, need in (("z_a", needs[0]), ("z_b", needs[2]), ("ray_norm", needs[4]),
                           ("noise", needs[5])):
            if need:
                raise ValueError(f"sort_integrate has no gradient for {name}; detach it")
        launch = OP if torch.compiler.is_exporting() else _launch_forward
        out = launch(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode, last_back, white_back)
        ctx.save_for_backward(z_a, vals_a, z_b, vals_b, ray_norm, noise)
        ctx.opts = dict(clamp_mode=clamp_mode, last_back=last_back, white_back=white_back)
        return out

    @staticmethod
    def backward(ctx, g_feat, g_depth, g_wsum):
        z_a, vals_a, z_b, vals_b, ray_norm, noise = ctx.saved_tensors
        B, R, _, c1 = vals_a.shape
        cot = [torch.zeros(B, R, n, device=vals_a.device) if g is None else g.float().contiguous()
               for g, n in ((g_feat, c1 - 1), (g_depth, 1), (g_wsum, 1))]
        grad_a, grad_b = _SortIntegrateBackwardFn.apply(z_a, vals_a, z_b, vals_b, ray_norm, noise,
                                                        *cot, ctx.opts)
        return None, grad_a, None, grad_b, None, None, None, None, None


def sort_integrate(
    z_a: torch.Tensor,
    vals_a: torch.Tensor,
    z_b: torch.Tensor,
    vals_b: torch.Tensor,
    ray_norm: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    clamp_mode: str = "softplus",
    last_back: bool = False,
    white_back: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on the tensors' device: the CUDA kernel on CUDA (differentiable in
    the values through `sort_integrate_backward`), the plain version on the
    CPU (through the operator while `torch.export` traces). Returns (features
    [B,R,C], depth [B,R,1], weights_sum [B,R,1]) in fp32."""
    if z_a.device.type == "cpu" and not torch.compiler.is_exporting():
        return sort_integrate_plain(z_a, vals_a, z_b, vals_b, ray_norm, noise=noise,
                                    clamp_mode=clamp_mode, last_back=last_back,
                                    white_back=white_back)
    if z_a.device.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"sort_integrate has no kernel for {z_a.device}")
    return _SortIntegrateFn.apply(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode,
                                  last_back, white_back)


sort_integrate.launches = 0  # kernel launches since the last reset; the plain path never counts
