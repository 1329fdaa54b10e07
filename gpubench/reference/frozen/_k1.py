"""K1, the merged depth sort and composite, as the plain PyTorch function the
CUDA kernel is held to: stable sort, softplus or relu density, the last
delta 1e10, transmittance from the cumulative sum, weights back in input
order."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def sort_integrate(z_a, vals_a, z_b, vals_b, ray_norm, noise=None, clamp_mode="softplus",
                   last_back=False, white_back=False):
    return sort_integrate_plain(z_a, vals_a, z_b, vals_b, ray_norm, noise=noise,
                                clamp_mode=clamp_mode, last_back=last_back, white_back=white_back)
