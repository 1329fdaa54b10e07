"""Volumetric compositing + hierarchical importance sampling, plain PyTorch.

Counterpart of ide3d_tpu/render/integration.py. Compositing runs in fp32
whatever the feature dtype. The JAX package replaces sorts and searchsorted by
comparison matrices and one-hot matmuls, for the TPU; here they are
torch.sort, torch.searchsorted and gathers, which compute the same values.
The merged fine composite of `render_fine` is K1 (ops/ray_march.py), for
every option; `integrate_rays_merged` is the counterpart of the JAX function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import draw

LOG_EPS = -23.025850929940457  # log(1e-10)


def _density(sigmas: torch.Tensor, clamp_mode: str, noise_std: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if generator is not None and noise_std > 0:
        sigmas = sigmas + draw(torch.randn, sigmas.shape, generator=generator,
                               device=sigmas.device) * noise_std
    if clamp_mode == "softplus":
        return F.softplus(sigmas)
    if clamp_mode == "relu":
        return F.relu(sigmas)
    raise ValueError("clamp_mode must be 'softplus' or 'relu'")


def integrate_rays(
    feats_sigma: torch.Tensor,  # [B, R, S, C+1]; last channel = raw sigma
    rays_d_cam: torch.Tensor,  # [B, R, 3]
    z_vals: torch.Tensor,  # [B, R, S, 1], sorted
    generator: Optional[torch.Generator] = None,
    noise_std: float = 0.0,
    last_back: bool = False,
    white_back: bool = False,
    clamp_mode: str = "softplus",
    weights_only: bool = False,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], torch.Tensor]:
    """NeRF alpha compositing over depth-sorted samples.

    Returns (features [B,R,C], depth [B,R,1], weights [B,R,S,1]);
    `weights_only=True` skips the sums and returns (None, None, weights)."""
    sigmas = feats_sigma[..., -1:].float()
    z_vals = z_vals.float()

    deltas = z_vals[:, :, 1:] - z_vals[:, :, :-1]  # [B,R,S-1,1]
    ray_norm = torch.linalg.vector_norm(rays_d_cam.float(), dim=-1, keepdim=True)
    deltas = deltas * ray_norm[:, :, None, :]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :, :1], 1e10)], dim=-2)

    density = _density(sigmas, clamp_mode, noise_std, generator)
    alphas = 1.0 - torch.exp(-deltas * density)
    shifted = torch.cat([torch.ones_like(alphas[:, :, :1]), 1.0 - alphas + 1e-10], dim=-2)
    weights = alphas * torch.cumprod(shifted, dim=-2)[:, :, :-1]
    if weights_only:
        return None, None, weights
    weights_sum = weights.sum(dim=-2)

    if last_back:
        weights = weights.clone()
        weights[:, :, -1] += 1.0 - weights_sum

    out = (weights * feats_sigma[..., :-1].float()).sum(dim=-2)
    depth = (weights * z_vals).sum(dim=-2)
    if white_back:
        out = out + (1.0 - weights_sum)
    return out, depth, weights


def integrate_rays_merged(
    feats_sigma: torch.Tensor,  # [B, R, S, C+1]; ANY depth order
    rays_d_cam: torch.Tensor,  # [B, R, 3]
    z_vals: torch.Tensor,  # [B, R, S, 1], not necessarily sorted
    generator: Optional[torch.Generator] = None,
    noise_std: float = 0.0,
    last_back: bool = False,
    white_back: bool = False,
    clamp_mode: str = "softplus",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alpha compositing over unsorted samples: stable sort (ties by index),
    then compositing with log(1 - alpha) = -delta*density floored at log(1e-10).

    Returns (features [B,R,C], depth [B,R,1], weights [B,R,S,1]) with the
    weights in the INPUT sample order."""
    z = z_vals[..., 0].float()
    zs, order = torch.sort(z, dim=-1, stable=True)
    sigmas = feats_sigma[..., -1].float()
    if generator is not None and noise_std > 0:  # in input order, as the JAX function
        sigmas = sigmas + draw(torch.randn, sigmas.shape, generator=generator,
                               device=sigmas.device) * noise_std
    density = _density(torch.gather(sigmas, -1, order), clamp_mode, 0.0, None)

    big = 1e10
    nxt = torch.cat([zs[..., 1:], torch.full_like(zs[..., :1], big)], dim=-1)
    deltas = torch.where(nxt >= big, torch.full_like(zs, big), nxt - zs)
    deltas = deltas * torch.linalg.vector_norm(rays_d_cam.float(), dim=-1)[..., None]

    alphas = 1.0 - torch.exp(-deltas * density)
    log1m = torch.clamp(-deltas * density, min=LOG_EPS)
    log_t = torch.cat([torch.zeros_like(log1m[..., :1]), torch.cumsum(log1m[..., :-1], dim=-1)], -1)
    w_sorted = alphas * torch.exp(log_t)
    weights_sum = w_sorted.sum(dim=-1, keepdim=True)
    if last_back:
        w_sorted = w_sorted.clone()
        w_sorted[..., -1:] += 1.0 - weights_sum
    weights = torch.empty_like(w_sorted).scatter_(-1, order, w_sorted)

    out = torch.einsum("brs,brsc->brc", weights, feats_sigma[..., :-1].float())
    depth = (w_sorted * zs).sum(dim=-1, keepdim=True)
    if white_back:
        out = out + (1.0 - weights_sum)
    return out, depth, weights[..., None]


def sample_pdf(
    bins: torch.Tensor,  # [R, S+1] bin edges
    weights: torch.Tensor,  # [R, S] coarse weights
    n_importance: int,
    generator: Optional[torch.Generator] = None,
    det: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Inverse-CDF importance sampling: [R, n_importance] new depths.

    `det=True` (or no generator) takes CDF positions linspace(0, 1); the bin
    is found with searchsorted on the left side (count of CDF entries < u)."""
    R, S = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()  # [R, S+1]

    if det or generator is None:
        u = torch.linspace(0.0, 1.0, n_importance, device=cdf.device, dtype=cdf.dtype)
        u = u.expand(R, n_importance).contiguous()
    else:
        u = draw(torch.rand, (R, n_importance), generator=generator, device=cdf.device,
                 dtype=cdf.dtype)

    inds = torch.searchsorted(cdf, u, right=False)
    below = (inds - 1).clamp(0, S)
    above = inds.clamp(0, S)
    cdf_g0, cdf_g1 = cdf.gather(1, below), cdf.gather(1, above)
    bins_g0, bins_g1 = bins.gather(1, below), bins.gather(1, above)

    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
