"""K1: depth sort + alpha compositing of the merged coarse and fine samples.

Counterpart of `sort_integrate_pallas` (ide3d_tpu/ops/pallas/ray_march.py), the
JAX package's TPU kernel, with the options of the fine composite
`integrate_rays_merged` (ide3d_tpu/render/integration.py): density noise,
softplus or relu clamp, last_back and white_back. `sort_integrate` is the
entry point:

  * on CUDA tensors it launches the hand-written kernel in csrc/ray_march.cu
    (built by nvcc at first use) or raises; it never falls back,
  * on CPU tensors it runs `sort_integrate_plain`, the plain PyTorch version
    with the kernel's semantics.

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


@functools.cache
def _kernel_fn():
    fn = _build.load("ray_march").ide3d_sort_integrate
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, i, p, p, i, p, p, i, i, i, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


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
    """K1 on the tensors' device: the CUDA kernel on CUDA, the plain version on
    the CPU. Returns (features [B,R,C], depth [B,R,1], weights_sum [B,R,1]) in fp32."""
    if z_a.device.type == "cpu":
        return sort_integrate_plain(z_a, vals_a, z_b, vals_b, ray_norm, noise=noise,
                                    clamp_mode=clamp_mode, last_back=last_back,
                                    white_back=white_back)
    if z_a.device.type != "cuda":
        raise NotImplementedError(f"sort_integrate has no kernel for {z_a.device}")
    _check(z_a, vals_a, z_b, vals_b, ray_norm, noise, clamp_mode)
    B, R, s_a, _ = z_a.shape
    s_b = z_b.shape[2]
    c1 = vals_a.shape[-1]
    dev = z_a.device
    feat = torch.empty(B, R, c1 - 1, device=dev, dtype=torch.float32)
    depth = torch.empty(B, R, 1, device=dev, dtype=torch.float32)
    wsum = torch.empty(B, R, 1, device=dev, dtype=torch.float32)
    rc = _kernel_fn()(
        dev.index if dev.index is not None else torch.cuda.current_device(),
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


sort_integrate.launches = 0  # kernel launches since the last reset; the plain path never counts
