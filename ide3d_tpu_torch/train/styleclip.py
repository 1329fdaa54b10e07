"""StyleCLIP: the LevelsMapper trainer and latent optimization over a frozen G.

Counterpart of ide3d_tpu/train/styleclip.py (the reference's
StyleCLIP/mapper/training/coach.py and run_optimization.py):

    w_hat = w + 0.1 * mapper(w); x = G(w); x_hat = G(w_hat)
    L = id_lambda * IDLoss(x_hat, x) + clip_lambda * CLIPLoss(x_hat, text)
        + latent_l2_lambda * MSE(w_hat, w)

with the defaults lr 0.5, id 0.1, clip 1.0, latent_l2 0.8, batch 2
(mapper/options/train_options.py:27-32); Adam (the reference's alternative to
Ranger). Latents come from G.mapping at truncation 0.7 (coach.py:164-186);
renders are at the canonical front pose. The ID term embeds through a given
embedder (ArcFace's `embed_faces`) and renders x = G(w) without gradient.

Eager PyTorch, one mapper step = the edited render with its backward (K1
and its backward on the card), plus the w render when the ID term is on.
Gradients are taken for the optimized tensors alone (torch.autograd.grad),
so G's parameters get none. The latent optimizer sets its cosine-ramped lr
in the optimizer's param_groups before each step. Latent draws come from a
torch.Generator (the JAX package's from jax.random: the parity tests pass w).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..editing.latent_editor import LevelsMapper
from ..models.clip import CLIP, clip_similarity_loss
from ..render.camera import CANONICAL_POSE_25
from .losses import cosine_id_loss


@dataclasses.dataclass(frozen=True)
class StyleClipConfig:
    description: str = "a face with purple hair"
    lr: float = 0.5
    id_lambda: float = 0.1
    clip_lambda: float = 1.0
    latent_l2_lambda: float = 0.8
    batch_size: int = 2
    max_steps: int = 50_000
    truncation_psi: float = 0.7
    edit_strength: float = 0.1  # styleclip_mapper.py: x + 0.1 * mapper(x)


def _front(G, n: int) -> torch.Tensor:
    return torch.as_tensor(CANONICAL_POSE_25, device=G.mapping.w_avg.device)[None].expand(n, -1)


@torch.no_grad()
def sample_latents(G, n: int, generator: torch.Generator,
                   truncation_psi: float = 0.7) -> torch.Tensor:
    """The coach's 'no latents given' path (coach.py:164-186): the decoder's
    own latent distribution with truncation, at the canonical pose."""
    z = torch.randn(n, G.z_dim, generator=generator, device=G.mapping.w_avg.device)
    return G.mapping(z, _front(G, n), truncation_psi=truncation_psi)


def styleclip_loss(G, mapper: LevelsMapper, clip_model: CLIP, text_tokens: torch.Tensor,
                   w: torch.Tensor, cfg: StyleClipConfig = StyleClipConfig(),
                   embed_id: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """(loss, stats) of the mapper step at latents w [B, num_ws, w_dim]."""
    c = _front(G, w.shape[0])
    w_hat = w + cfg.edit_strength * mapper(w)
    x_hat = G.synthesis(w_hat, c)
    stats = {}
    loss = torch.zeros((), device=w.device)
    if cfg.clip_lambda > 0:
        l_clip = clip_similarity_loss(clip_model, x_hat, text_tokens).mean()
        stats["loss_clip"] = l_clip
        loss = loss + cfg.clip_lambda * l_clip
    if cfg.id_lambda > 0 and embed_id is not None:
        with torch.no_grad():
            x = G.synthesis(w, c)
        l_id = cosine_id_loss(embed_id, x_hat, x)
        stats["loss_id"] = l_id
        loss = loss + cfg.id_lambda * l_id
    if cfg.latent_l2_lambda > 0:
        l_l2 = (w_hat - w).square().mean()
        stats["loss_l2_latent"] = l_l2
        loss = loss + cfg.latent_l2_lambda * l_l2
    stats["loss"] = loss
    return loss, stats


def make_styleclip_step(G, mapper: LevelsMapper, clip_model: CLIP, text_tokens: torch.Tensor,
                        cfg: StyleClipConfig = StyleClipConfig(),
                        embed_id: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """step(w) -> stats (detached tensors): one Adam step of the mapper (in place)."""
    params = list(mapper.parameters())
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)

    @torch.enable_grad()
    def step(w: torch.Tensor) -> dict:
        _, stats = styleclip_loss(G, mapper, clip_model, text_tokens, w, cfg, embed_id)
        for p, g in zip(params, torch.autograd.grad(stats["loss"], params)):
            p.grad = g
        opt.step()
        return {k: v.detach() for k, v in stats.items()}

    return step


def lr_ramp(step: int, steps: int, lr: float) -> float:
    """run_optimization.py's get_lr (:17-22): a cosine ramp down over the last
    quarter, a linear ramp up over the first 5%."""
    t = step / steps
    ramp = min(1.0, (1.0 - t) / 0.25)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    return lr * ramp * min(1.0, t / 0.05)


@torch.enable_grad()
def optimize_latent(G, clip_model: CLIP, tokens: torch.Tensor, latent_init: torch.Tensor,
                    steps: int = 300, lr: float = 0.1, l2_lambda: float = 0.008,
                    mode: str = "edit", c: Optional[torch.Tensor] = None,
                    log_every: int = 50) -> torch.Tensor:
    """StyleCLIP's latent optimization (run_optimization.py:25-90): Adam on w+
    [1, num_ws, w_dim] with L = CLIPLoss(G(w), text), plus l2_lambda *
    ||w - w0||² in 'edit' mode, under `lr_ramp`. Returns the optimized latent."""
    c = _front(G, 1) if c is None else c
    w0 = latent_init.detach()
    w = w0.clone().float().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for i in range(steps):
        lr_t = lr_ramp(i, steps, lr)
        for group in opt.param_groups:
            group["lr"] = lr_t
        loss = clip_similarity_loss(clip_model, G.synthesis(w, c), tokens).mean()
        if mode == "edit":
            loss = loss + l2_lambda * (w - w0).square().sum()
        (w.grad,) = torch.autograd.grad(loss, [w])
        opt.step()
        if log_every and i % log_every == 0:
            print(f"step {i}: loss {float(loss.detach()):.4f} lr {lr_t:.4f}")
    return w.detach()


def train_styleclip_mapper(G, clip_model: CLIP, tokenizer,
                           cfg: StyleClipConfig = StyleClipConfig(),
                           mapper: Optional[LevelsMapper] = None, embed_id=None,
                           steps: Optional[int] = None, seed: int = 0,
                           log_every: int = 50) -> LevelsMapper:
    """The coach loop: `mapper` (all three groups at G's width when None)
    starts from `init(seed)`, latents are sampled each step from a
    torch.Generator seeded with `seed` on G's device. Returns the trained
    mapper, on G's device."""
    dev = G.mapping.w_avg.device
    mapper = (mapper or LevelsMapper(w_dim=G.w_dim, num_ws=G.num_ws)).init(seed).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.as_tensor(tokenizer.tokenize(
        [cfg.description], context_length=clip_model.cfg.context_length, truncate=True),
        device=dev)
    step_fn = make_styleclip_step(G, mapper, clip_model, tokens, cfg, embed_id)
    for i in range(cfg.max_steps if steps is None else steps):
        stats = step_fn(sample_latents(G, cfg.batch_size, gen, cfg.truncation_psi))
        if log_every and i % log_every == 0:
            print(f"step {i}: " + " ".join(
                f"{k}={float(v):.4f}" for k, v in sorted(stats.items())))
    return mapper
