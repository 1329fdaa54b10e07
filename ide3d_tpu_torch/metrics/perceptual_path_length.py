"""PPL: perceptual path length over latent interpolations.

Counterpart of ide3d_tpu/metrics/perceptual_path_length.py (contract:
metrics/perceptual_path_length.py:35-131; ppl2_wend is epsilon 1e-4, space
'w', sampling 'end', no crop, labels from the dataset's poses):
  * sampling 'end' -> t = 0; 'full' -> t ~ U[0, 1),
  * space 'w' -> lerp between the mapped w+; 'z' -> slerp in z, then map,
  * both renders of a pair use noise_mode='random' with the SAME draws: one
    torch.Generator seeded per step as seed * 7919 + step, reset before each
    of the two renders (layer noise, depth jitter, importance draws),
  * optional face centre crop, mean-pool to <= 256 before the detector,
  * 1%/99% quantile outlier filter with lower/higher interpolation.
The distance divides by epsilon² = 1e-8, so rounding in the two renders shows
in it (in bf16 most of it may be rounding), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .metric_utils import MetricOptions, sample_labels


def _slerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation (ppl.py:21-31)."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    d = (a * b).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d.clamp(-1.0, 1.0))
    c = b - d * a
    c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    out = a * torch.cos(p) + c * torch.sin(p)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def _crop_and_downsample(img: torch.Tensor, crop: bool) -> torch.Tensor:
    """Face centre crop + mean-pool to <= 256 (ppl.py:70-79). NHWC."""
    if crop:
        c = img.shape[1] // 8
        img = img[:, c * 3 : c * 7, c * 2 : c * 6, :]
    factor = max(img.shape[1] // 256, 1)
    if factor > 1:
        B, H, W, C = img.shape
        img = img.reshape(B, H // factor, factor, W // factor, factor, C).mean(dim=(2, 4))
    return img


def pair_distances(opts: MetricOptions, z0, z1, c, t, step: int, epsilon: float = 1e-4,
                   space: str = "w", crop: bool = False) -> torch.Tensor:
    """One batch of PPL pair distances [B] (fp32, on opts.device)."""
    G, det = opts.G, opts.detector
    if space == "w":
        ws0 = G.mapping(z0, c)
        ws1 = G.mapping(z1, c)
        wt0 = ws0 + (ws1 - ws0) * t[:, None, None]
        wt1 = ws0 + (ws1 - ws0) * (t[:, None, None] + epsilon)
    else:
        wt0 = G.mapping(_slerp(z0, z1, t[:, None]), c)
        wt1 = G.mapping(_slerp(z0, z1, t[:, None] + epsilon), c)
    gen = torch.Generator(device=z0.device)
    feats = []
    for wt in (wt0, wt1):
        gen.manual_seed(opts.seed * 7919 + step)  # the same draws for both renders
        img = G.synthesis(wt, c, noise_mode="random", generator=gen).float()
        feats.append(det(_crop_and_downsample(img, crop)).float())
    return (feats[0] - feats[1]).square().sum(dim=-1) / epsilon**2


def compute_ppl(
    opts: MetricOptions,
    epsilon: float = 1e-4,
    space: str = "w",
    sampling: str = "end",
    crop: bool = False,
) -> float:
    if space not in ("z", "w") or sampling not in ("full", "end"):
        raise ValueError(f"space must be 'z' or 'w' and sampling 'full' or 'end', got "
                         f"{space!r}, {sampling!r}")
    G, dev = opts.G, opts.device
    rs = np.random.RandomState(opts.seed)
    B = opts.batch_size

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    dists = []
    done = 0
    step = 0
    with torch.inference_mode():
        while done < opts.num_items:
            z0 = tensor(rs.randn(B, G.cfg.z_dim))
            z1 = tensor(rs.randn(B, G.cfg.z_dim))
            c = tensor(sample_labels(opts, rs, B))
            t = tensor(np.zeros(B) if sampling == "end" else rs.rand(B))
            d = pair_distances(opts, z0, z1, c, t, step, epsilon, space, crop)
            dists.append(d.cpu().numpy())
            done += B
            step += 1

    dists = np.concatenate(dists)[: opts.num_items]
    # 1%/99% quantile outlier filter, lower/higher interpolation (ppl.py:121-126)
    lo = np.percentile(dists, 1, method="lower")
    hi = np.percentile(dists, 99, method="higher")
    return float(dists[(dists >= lo) & (dists <= hi)].mean())
