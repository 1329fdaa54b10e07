"""Hybrid GAN inversion: the w+ projector and PTI pivotal tuning.

Counterpart of ide3d_tpu/train/pti.py (the reference's
projectors/w_plus_projector_ide3d.py and coaches/):

  1. projector: from the encoder's w (initial_w) or w_avg, optimize w+ and a
     re-initialized N(0, 1) copy of every per-layer noise buffer with Adam
     (lr 5e-3, betas 0.9 / 0.999) against a perceptual feature distance to the
     target plus 1e5 x the multi-scale noise autocorrelation; the lr ramps up
     and down on a cosine and the w exploration noise decays; the noise
     buffers are re-normalized after every step; 450 steps;
  2. pivotal tuning: the pivot w frozen, G's synthesis parameters tuned with
     Adam (3e-4) on L2 + LPIPS (+ the locality "ball holder" regularizer and
     the mirrored-view term of the join-view coach) until the main view's LPIPS
     reaches the threshold or 350 steps.

Both loops are eager PyTorch: one G pass and one backward a step (K1 and its
backward on the card). The projector reads its noise buffers into the
synthesis network through torch.func.functional_call, so the caller's G is
never written; PTI tunes a deep copy of G and returns it, the noise buffers
(parameters named `noise_const` in this package) left out of Adam and
unchanged. The lr is set in the optimizer's param_groups before each step.
PTI's early stop reads the main-view LPIPS back to the host every step, as
the JAX loop does. Random draws come from a torch.Generator; the parity tests
inject the draws that cannot match the JAX package's (`z_stats`,
`initial_noise`, `w_samples`).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..metrics.features import resize
from ..models.generator import Ide3dGenerator
from . import losses as L


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    num_steps: int = 450  # hyperparameters.first_inv_steps
    lr: float = 5e-3  # hyperparameters.first_inv_lr
    w_avg_samples: int = 600
    noise_reg_weight: float = 1e5  # regularize_noise_weight
    initial_noise_factor: float = 0.05
    lr_rampdown_length: float = 0.25
    lr_rampup_length: float = 0.05
    noise_ramp_length: float = 0.75
    optimize_noise: bool = True  # optimize the per-layer noise buffers jointly


@dataclasses.dataclass(frozen=True)
class PtiConfig:
    max_steps: int = 350
    lr: float = 3e-4
    lpips_threshold: float = 0.06
    w_l2: float = 1.0  # pt_l2_lambda
    w_lpips: float = 1.0  # pt_lpips_lambda
    # locality ("ball holder") regularization, hyperparameters.py:7-12
    use_locality: bool = False
    locality_interval: int = 1
    locality_samples: int = 1  # latent_ball_num_of_samples
    regularizer_l2: float = 0.1
    regularizer_lpips: float = 0.1
    regularizer_alpha: float = 30.0
    # mirrored-view consistency (the ide3d_join_view coach)
    join_view: bool = False


def default_pyramid_feats(img: torch.Tensor) -> list:
    """The fallback perceptual features until LPIPS weights exist: the image
    and three 2x-smaller copies (jax.image.resize's antialiased bilinear)."""
    feats, x = [img], img
    for _ in range(3):
        x = resize(x, x.shape[1] // 2)
        feats.append(x)
    return feats


def pyramid_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """PTI's distance without LPIPS weights: the pyramid features' mean squared
    difference, the target detached."""
    return L.multiscale_feature_loss(default_pyramid_feats, x, y)


@torch.no_grad()
def compute_w_stats(G: Ide3dGenerator, c: torch.Tensor, n: int = 600,
                    generator: Optional[torch.Generator] = None,
                    z: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, float]:
    """(w_avg [1, w_dim], w_std) of n mapped samples at c[:1] (z drawn from
    `generator` unless given). w_std = sqrt(sum((w - w_avg)²) / n): the sum over
    every element divided by the SAMPLE count, as the reference computes it
    (a mean over every element would shrink it, and with it the w exploration
    noise, by sqrt(w_dim))."""
    if z is None:
        z = torch.randn(n, G.z_dim, generator=generator, device=c.device)
    n = z.shape[0]
    ws = G.mapping(z.to(c.device), c[:1].expand(n, -1))[:, 0]
    w_avg = ws.mean(dim=0, keepdim=True)
    return w_avg, float(torch.sqrt((ws - w_avg).square().sum() / n))


# ------------------------------------------------------------- noise machinery


def noise_buffer_paths(synthesis: torch.nn.Module) -> list:
    """Dotted names (relative to the synthesis network) of every per-layer
    noise buffer; the same names as the JAX tree's paths."""
    return [n for n, _ in synthesis.named_parameters() if n.rsplit(".", 1)[-1] == "noise_const"]


@torch.no_grad()
def merge_noise(synthesis: torch.nn.Module, noise: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Copy the buffers of `noise` into the synthesis network's noise_const, in place."""
    params = dict(synthesis.named_parameters())
    for name, buf in noise.items():
        params[name].copy_(buf)
    return synthesis


def noise_regularization(noise: Dict[str, torch.Tensor]) -> torch.Tensor:
    """For each buffer, at each 2x average-pooled scale down to 8²:
    mean(n * roll(n, 1, x))² + mean(n * roll(n, 1, y))²."""
    reg = 0.0
    for buf in noise.values():
        n = buf[None, None]  # [1, 1, H, W]
        while True:
            reg = reg + (n * torch.roll(n, 1, dims=3)).mean() ** 2
            reg = reg + (n * torch.roll(n, 1, dims=2)).mean() ** 2
            if n.shape[2] <= 8:
                break
            n = F.avg_pool2d(n, 2)
    return reg


def normalize_noise(noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each buffer projected back to zero mean and unit variance."""
    out = {}
    for k, v in noise.items():
        v = v - v.mean()
        out[k] = v * torch.rsqrt(v.square().mean() + 1e-12)
    return out


def projector_schedule(step: int, cfg: ProjectorConfig, w_std: float) -> Tuple[float, float]:
    """(lr, w noise scale) of a step: the reference's lr rampup and cosine
    rampdown and its decaying w exploration noise."""
    t = step / cfg.num_steps
    w_noise_scale = (w_std * cfg.initial_noise_factor
                     * max(0.0, 1.0 - t / cfg.noise_ramp_length) ** 2)
    lr_ramp = min(1.0, (1.0 - t) / cfg.lr_rampdown_length)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t / cfg.lr_rampup_length)
    return cfg.lr * lr_ramp, w_noise_scale


def projector_loss(G: Ide3dGenerator, ws: torch.Tensor, noise: Dict[str, torch.Tensor],
                   c: torch.Tensor, target_feats: list,
                   cfg: ProjectorConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, dist) of one projector step at ws: the render with `noise` in
    place of G's buffers (the deterministic render), its feature distance to the
    target's features, plus noise_reg_weight x the noise regularization."""
    img = torch.func.functional_call(G.synthesis, noise, (ws, c), {"noise_mode": "const"})
    dist = sum((a - b).square().mean() for a, b in zip(default_pyramid_feats(img), target_feats))
    if not noise:
        return dist, dist
    return dist + cfg.noise_reg_weight * noise_regularization(noise), dist


@torch.enable_grad()
def project_w_plus(
    G: Ide3dGenerator,
    target_img: torch.Tensor,  # [1, R, R, 3] in [-1, 1]
    c: torch.Tensor,  # [1, 25]
    cfg: ProjectorConfig = ProjectorConfig(),
    initial_w: Optional[torch.Tensor] = None,  # [1, num_ws, w_dim], the encoder's warm start
    generator: Optional[torch.Generator] = None,
    verbose: bool = False,
    return_noise: bool = False,
    z_stats: Optional[torch.Tensor] = None,
    initial_noise: Optional[Dict[str, torch.Tensor]] = None,
):
    """Optimize w+ (and the noise buffers) toward the target. Returns ws
    [1, num_ws, w_dim] (and the optimized noise buffers, by name, with
    return_noise). Draws, in order from `generator` (seed 0 on the target's
    device when None): the w statistics' z, the noise init, then each step's w
    noise; `z_stats` and `initial_noise` replace the first two."""
    dev = target_img.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    w_avg, w_std = compute_w_stats(G, c, cfg.w_avg_samples, generator, z=z_stats)
    w0 = w_avg[:, None].repeat(1, G.num_ws, 1) if initial_w is None else initial_w
    w = w0.detach().clone().float().requires_grad_(True)

    noise = {}
    if cfg.optimize_noise:
        params = dict(G.synthesis.named_parameters())
        for name in noise_buffer_paths(G.synthesis):
            buf = (initial_noise[name] if initial_noise is not None
                   else torch.randn(params[name].shape, generator=generator, device=dev))
            noise[name] = buf.detach().clone().float().to(dev).requires_grad_(True)

    with torch.no_grad():
        target_feats = [f.detach() for f in default_pyramid_feats(target_img)]
    variables = [w, *noise.values()]
    opt = torch.optim.Adam(variables, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    for i in range(cfg.num_steps):
        lr, w_noise_scale = projector_schedule(i, cfg, w_std)
        for group in opt.param_groups:
            group["lr"] = lr
        ws = w
        if w_noise_scale > 0:
            ws = w + torch.randn(w.shape, generator=generator, device=dev) * w_noise_scale
        loss, dist = projector_loss(G, ws, noise, c, target_feats, cfg)
        # Gradients for the optimized variables only: G's own .grad stays untouched.
        for v, g in zip(variables, torch.autograd.grad(loss, variables)):
            v.grad = g
        opt.step()
        with torch.no_grad():
            for k, v in normalize_noise(noise).items():
                noise[k].copy_(v)
        if verbose and i % 50 == 0:
            print(f"projector step {i}: dist {float(dist.detach()):.4f}")
    w = w.detach()
    if return_noise:
        return w, {k: v.detach() for k, v in noise.items()}
    return w


# --------------------------------------------------------------- pivotal tuning


def flip_label_25(c: torch.Tensor) -> torch.Tensor:
    """x-mirror a 25-dim camera label (the dataset's xflip relabeling:
    label[[1, 2, 3, 4, 8]] *= -1)."""
    sign = np.ones(25, np.float32)
    sign[[1, 2, 3, 4, 8]] = -1.0
    return c * torch.as_tensor(sign, device=c.device)


def locality_loss(
    G: Ide3dGenerator,  # the generator being tuned
    G_orig: Ide3dGenerator,  # the frozen generator before tuning
    w_pivot: torch.Tensor,
    c: torch.Tensor,
    cfg: PtiConfig,
    lpips_fn: Callable,
    generator: Optional[torch.Generator] = None,
    w_samples: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ball-holder regularizer: mapped latents (psi 0.5, from z drawn from
    `generator` unless `w_samples` is given) moved to radius alpha around the
    pivot; the tuned G must match the frozen G there (L2 + LPIPS), both
    rendered without noise."""
    n = cfg.locality_samples if w_samples is None else w_samples.shape[0]
    cs = c[:1].expand(n, -1)
    if w_samples is None:
        z = torch.randn(n, G_orig.z_dim, generator=generator, device=c.device)
        with torch.no_grad():
            w_samples = G_orig.mapping(z, cs, truncation_psi=0.5)
    direction = w_samples - w_pivot
    norm = torch.sqrt(direction.square().sum(dim=(1, 2), keepdim=True) + 1e-12)
    w_moved = w_pivot + cfg.regularizer_alpha * direction / norm

    new_img = G.synthesis(w_moved, cs, noise_mode="none")
    with torch.no_grad():
        old_img = G_orig.synthesis(w_moved, cs, noise_mode="none")
    loss = 0.0
    if cfg.regularizer_l2 > 0:
        loss = loss + cfg.regularizer_l2 * L.l2(old_img, new_img)
    if cfg.regularizer_lpips > 0:
        # the tuned render first: lpips_fn detaches its second argument
        loss = loss + cfg.regularizer_lpips * lpips_fn(new_img, old_img)
    return loss


def trainable_synthesis_params(G: Ide3dGenerator) -> list:
    """PTI's parameters: the synthesis network's, less the noise buffers (the
    reference's Adam runs over G.parameters(), where they are buffers)."""
    return [p for n, p in G.synthesis.named_parameters() if n.rsplit(".", 1)[-1] != "noise_const"]


def pti_loss(G: Ide3dGenerator, G_orig: Ide3dGenerator, w_pivot: torch.Tensor,
             target_img: torch.Tensor, c: torch.Tensor, cfg: PtiConfig, lpips_fn: Callable,
             use_locality: bool = False,
             generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, the main view's unweighted LPIPS) of one PTI step: the
    reconstruction at c, + the mirrored view (the x-flipped target at the
    x-flipped camera) with join_view, + the locality term when
    `use_locality`. The LPIPS is what the early stop reads; the mirrored term
    does not enter it."""

    def recon(tgt, cc):
        img = G.synthesis(w_pivot, cc, noise_mode="const")
        lp = lpips_fn(img, tgt)
        return L.l2(img, tgt) * cfg.w_l2 + lp * cfg.w_lpips, lp

    loss, lp = recon(target_img, c)
    if cfg.join_view:
        loss = loss + recon(target_img.flip(2), flip_label_25(c))[0]
    if use_locality:
        loss = loss + locality_loss(G, G_orig, w_pivot, c, cfg, lpips_fn, generator)
    return loss, lp


@torch.enable_grad()
def pivotal_tune(
    G: Ide3dGenerator,
    w_pivot: torch.Tensor,  # [1, num_ws, w_dim]
    target_img: torch.Tensor,
    c: torch.Tensor,
    cfg: PtiConfig = PtiConfig(),
    lpips_fn: Optional[Callable] = None,  # (x, y) -> scalar; None = the pyramid distance
    generator: Optional[torch.Generator] = None,
    verbose: bool = False,
) -> Ide3dGenerator:
    """Tune a copy of G around the pivot and return it (G is not changed).
    join_view adds the mirrored-view loss (the pivot at the x-flipped camera
    against the x-flipped target); use_locality adds the ball-holder term
    against G itself, every locality_interval steps. Stops when the main view's
    LPIPS <= lpips_threshold (a host readback every step) or after max_steps."""
    G_orig = G
    G = copy.deepcopy(G_orig).requires_grad_(False)
    params = trainable_synthesis_params(G)
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    lpips_fn = pyramid_distance if lpips_fn is None else lpips_fn
    w_pivot = w_pivot.detach()
    if generator is None:
        generator = torch.Generator(device=w_pivot.device).manual_seed(0)
    for i in range(cfg.max_steps):
        use_loc = cfg.use_locality and i % cfg.locality_interval == 0
        loss, lp = pti_loss(G, G_orig, w_pivot, target_img, c, cfg, lpips_fn, use_loc, generator)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        lp_val = float(lp.detach())  # the early stop's readback, every step
        if verbose and i % 25 == 0:
            print(f"pti step {i}: loss {float(loss.detach()):.4f} lpips {lp_val:.4f}")
        if lp_val <= cfg.lpips_threshold:
            break
    return G.requires_grad_(False)
