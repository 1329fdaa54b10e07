"""Semantic-aware 3D GAN training step, in PyTorch.

Counterpart of ide3d_tpu/train/gan.py, with the same losses and schedule:
  * non-saturating logistic losses on the dual-branch, seg-conditioned D input
    (img ++ the raw render upsampled to 512² ++ the 19 semantic channels),
  * lazy R1 on the real triple every `r1_interval` steps, at gamma/2 *
    interval, by a double backward (`torch.autograd.grad(create_graph=True)`)
    taken with respect to the PRE-augmentation triple, through ADA,
  * lazy path-length regularization of G (`pl_weight > 0`) every
    PL_INTERVAL steps, at pl_weight * interval, with the running pl_mean: the
    ws-Jacobian of a random projection of the image, differentiated again, so
    that K1 runs its double backward (ops/ray_march.py),
  * generator-pose conditioning swap and style mixing in the mapping,
  * ADA inside both losses (train/augment.py), one transform per sample for
    real and fake alike,
  * the G-first order with fake reuse (G updates against the pre-step D, then
    D trains on the same, detached, pre-augmentation fakes), or D-first with a
    fresh batch of fakes (`fake_reuse=False`),
  * Adam(betas=(0, 0.99), eps=1e-8) on fp32 parameters, which computes what
    `optax.adam` computes; the w_avg EMA of the mapping and G_ema after each G
    update.

Every draw comes from one torch.Generator on the step's device. The losses
take the D-input function `d_in` (triple -> D input) so that a caller can
hold them at given augmentation draws. Not ported: the JAX package's split
program cut (XLA program structure). The step skips ADA at p = 0, where the
JAX step runs an identity warp: the same D input up to the warp's rounding.

Data parallelism (`make_gan_train_step(tcfg, group)`, parallel/mesh.py): the
batch is this rank's rows of the global batch, and the step computes what the
JAX step computes on the global array: every draw is made at the global shape
and sliced (the ranks' generators stay equal), D's minibatch stddev spans the
global batch, the pose swap rolls the global batch (a rank's first sample
takes the previous rank's last camera), each phase's gradients (G, D, lazy
R1, PL) are averaged as one flat buffer, and the w_avg EMA and pl_mean follow
global means. Every rank takes R1 and PL on the same steps.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.discriminator import Discriminator
from ..models.generator import GeneratorConfig, Ide3dGenerator
from ..ops import conv2d_gradfix
from ..parallel.mesh import Group, all_reduce_grads, draw, global_draws, rows
from ..utils.profiling import span
from .augment import AugmentConfig, augment_d_input

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (img, raw_up, seg), NHWC
PL_INTERVAL = 4  # path-length regularization runs on every 4th step
PL_DECAY = 0.01  # the running pl_mean's rate


@dataclasses.dataclass(frozen=True)
class GanTrainConfig:
    g_lr: float = 0.0025
    d_lr: float = 0.002
    beta1: float = 0.0
    beta2: float = 0.99
    r1_gamma: float = 1.0
    r1_interval: int = 16
    ema_beta: float = 0.998
    use_seg_d: bool = True  # D also sees the semantic channels
    style_mixing_prob: float = 0.9
    w_avg_beta: float = 0.995
    gpc_swap_prob: float = 0.5  # generator-pose-conditioning swap (mapping only)
    use_ada: bool = True
    aug: AugmentConfig = AugmentConfig()
    pl_weight: float = 0.0  # path-length regularization (0 = off)
    fake_reuse: bool = True  # G-first, the D phase reuses the G phase's fakes


@dataclasses.dataclass
class GanTrainState:
    """The training state: the three networks, both optimizers, the step and
    pl_mean (path-length regularization's running mean length)."""

    G: Ide3dGenerator
    D: Discriminator
    G_ema: Ide3dGenerator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0
    pl_mean: Optional[torch.Tensor] = None


def expand_compact_batch(batch: Dict[str, torch.Tensor], num_classes: int = 19) -> Dict[str, torch.Tensor]:
    """Wire batch (img uint8 [B,H,W,3], seg uint8 class ids [B,H,W]) -> the
    step's (img fp32 in [-1,1], seg fp32 one-hot in {-1,1}), on the batch's
    device. Keys already in the step's format pass through."""
    out = dict(batch)
    img = out.get("img")
    if img is not None and img.dtype == torch.uint8:
        out["img"] = img.float() / 127.5 - 1.0
    seg = out.get("seg")
    if seg is not None and seg.dtype == torch.uint8:
        out["seg"] = F.one_hot(seg.long(), num_classes).float() * 2.0 - 1.0
    return out


def d_input_channels(tcfg: GanTrainConfig, gcfg: GeneratorConfig) -> int:
    ch = gcfg.img_channels * 2  # rgb ++ upsampled raw rgb
    if tcfg.use_seg_d:
        ch += gcfg.seg_channels
    return ch


def init_gan_state(G: Ide3dGenerator, D: Discriminator, tcfg: GanTrainConfig) -> GanTrainState:
    """State around initialised G and D (on their device): G_ema a copy of G,
    fresh Adam optimizers, step 0."""
    adam = functools.partial(torch.optim.Adam, betas=(tcfg.beta1, tcfg.beta2), eps=1e-8)
    return GanTrainState(G=G, D=D, G_ema=copy.deepcopy(G).eval().requires_grad_(False),
                         opt_g=adam(G.parameters(), lr=tcfg.g_lr),
                         opt_d=adam(D.parameters(), lr=tcfg.d_lr), step=0,
                         pl_mean=torch.zeros((), device=next(G.parameters()).device))


def pose_swap(c: Optional[torch.Tensor], gen: torch.Generator, prob: float,
              group: Optional[Group] = None) -> Optional[torch.Tensor]:
    """With probability `prob` per sample, condition the mapping on the
    previous sample's camera (a roll of the global batch over `group`);
    rendering keeps c."""
    if prob <= 0 or c is None:
        return c
    group = group or Group()
    swap = draw(torch.rand, (c.shape[0], 1), generator=gen, device=c.device) < prob
    c_all = group.all_gather(c)
    prev = torch.roll(c_all, 1, dims=0)[rows(group, c_all.shape[0])]
    return torch.where(swap, prev, c)


def map_ws(G: Ide3dGenerator, z: torch.Tensor, c: torch.Tensor, tcfg: GanTrainConfig,
           gen: Optional[torch.Generator], group: Optional[Group] = None) -> torch.Tensor:
    """The mapping with the pose swap and style mixing (rows >= a random
    cutoff from a second latent, with probability style_mixing_prob); both
    need a generator and are off without one."""
    if gen is None:
        return G.mapping(z, c)
    c_map = pose_swap(c, gen, tcfg.gpc_swap_prob, group)
    ws = G.mapping(z, c_map)
    if tcfg.style_mixing_prob > 0:
        B, dev = z.shape[0], z.device
        ws2 = G.mapping(draw(torch.randn, z.shape, generator=gen, device=dev), c_map)
        num_ws = ws.shape[1]
        cutoff = draw(functools.partial(torch.randint, 1, num_ws), (B, 1), generator=gen,
                      device=dev)
        do_mix = draw(torch.rand, (B, 1), generator=gen, device=dev) < tcfg.style_mixing_prob
        take2 = (torch.arange(num_ws, device=dev)[None, :] >= cutoff) & do_mix
        ws = torch.where(take2[..., None], ws2, ws)
    return ws


def synth_fake(G: Ide3dGenerator, z: torch.Tensor, c: torch.Tensor, tcfg: GanTrainConfig,
               gen: Optional[torch.Generator], group: Optional[Group] = None) -> dict:
    """G's outputs for latents z: random layer noise, depth jitter and importance
    draws from `gen`; without one, const noise and the deterministic render."""
    ws = map_ws(G, z, c, tcfg, gen, group)
    return G.synthesis(ws, c, noise_mode="random" if gen is not None else "const",
                       generator=gen, return_all=True)


def _resize(x: torch.Tensor, size: int, antialias: bool = False) -> torch.Tensor:
    """NHWC bilinear resize with half-pixel centres; antialias when shrinking,
    which is what jax.image.resize(..., 'bilinear') computes."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=antialias)
    return y.permute(0, 2, 3, 1)


def d_triple_fake(out: dict) -> Triple:
    return out["img"], _resize(out["img_raw"], out["img"].shape[1]), out["seg"]


def d_triple_real(img: torch.Tensor, seg: torch.Tensor, render_size: int) -> Triple:
    """The real image, its render-size version brought back up (D's raw
    branch sees what a render at that size would show), and the real seg."""
    raw = _resize(img, render_size, antialias=True)
    return img, _resize(raw, img.shape[1]), seg


def d_input(triple: Triple, tcfg: GanTrainConfig, gen: Optional[torch.Generator],
            ada_p: float) -> torch.Tensor:
    """Concatenate D's input, with ADA at p when p > 0 and a generator is given."""
    img, raw_up, seg = triple
    if tcfg.use_ada and gen is not None and ada_p > 0:
        img, raw_up, seg = augment_d_input(gen, img, raw_up, seg, ada_p, tcfg.aug)
    parts = [img, raw_up] + ([seg] if tcfg.use_seg_d else [])
    return torch.cat(parts, dim=-1)


DInput = Callable[[Triple], torch.Tensor]


def g_loss(G: Ide3dGenerator, D: Discriminator, z: torch.Tensor, c: torch.Tensor,
           tcfg: GanTrainConfig, gen: Optional[torch.Generator], d_in: DInput,
           group: Optional[Group] = None):
    """-> (loss, stats, the detached pre-augmentation fake triple)."""
    triple = d_triple_fake(synth_fake(G, z, c, tcfg, gen, group))
    logits = D(d_in(triple), c, group)
    loss = F.softplus(-logits).mean()
    stats = {"loss_g": loss.detach(), "fake_logits": logits.detach().mean()}
    return loss, stats, tuple(x.detach() for x in triple)


def d_loss(D: Discriminator, fake: Triple, real: Triple, c: torch.Tensor, d_in: DInput,
           group: Optional[Group] = None):
    """-> (loss, stats). When the global batch is a multiple of the
    minibatch-stddev group, one D call over INTERLEAVED rows (fake0, real0,
    fake1, ...): the strided stddev groups then stay single-half and the
    logits equal those of two separate calls; otherwise two calls."""
    B = c.shape[0] * (group.size if group is not None else 1)
    if B % D.mbstd_group_size == 0:
        both = tuple(torch.stack([f, r], dim=1).reshape((-1,) + f.shape[1:])
                     for f, r in zip(fake, real))
        logits = D(d_in(both), c.repeat_interleave(2, dim=0), group)
        fake_logits, real_logits = logits[0::2], logits[1::2]
    else:
        fake_logits, real_logits = D(d_in(fake), c, group), D(d_in(real), c, group)
    loss = F.softplus(fake_logits).mean() + F.softplus(-real_logits).mean()
    return loss, {"loss_d": loss.detach(), "real_logits": real_logits.detach().mean(),
                  "real_signs": torch.sign(real_logits.detach()).mean()}


def r1_penalty(D: Discriminator, real: Triple, c: torch.Tensor, d_in: DInput,
               group: Optional[Group] = None) -> torch.Tensor:
    """E ||d D(d_in(x)).sum() / d x||² over the pre-augmentation real triple
    (its three parts as independent inputs), differentiable in D's parameters.
    Under a group, D's logits of every rank enter the sum (through the
    minibatch stddev) and the mean is this rank's part of the global one."""
    x = tuple(t.detach().requires_grad_() for t in real)
    logits = D(d_in(x), c, group)
    with conv2d_gradfix.no_weight_gradients():  # this pass needs the input gradient only
        grads = torch.autograd.grad(logits.sum(), x, create_graph=True, allow_unused=True)
    return sum(g.square().sum() for g in grads if g is not None) / x[0].shape[0]


def pl_penalty(G: Ide3dGenerator, ws: torch.Tensor, c: torch.Tensor, pl_mean: torch.Tensor,
               gen: Optional[torch.Generator], y: Optional[torch.Tensor] = None):
    """StyleGAN2 path-length regularization at the latents ws: the lengths
    sqrt(mean_rows(sum_cols(J²))) of J = d sum(img * y) / d ws, with y ~ N(0, 1)
    / sqrt(H W) drawn from `gen` unless given, and -> (mean((lengths - pl_mean)²),
    lengths), differentiable in G's parameters (and in ws's own graph). The
    synthesis draws its layer noise and render from `gen` (const noise and the
    deterministic render without one)."""
    img = G.synthesis(ws, c, noise_mode="random" if gen is not None else "const",
                      generator=gen).float()
    if y is None:
        y = draw(torch.randn, img.shape, generator=gen, device=img.device) / math.sqrt(
            img.shape[1] * img.shape[2])
    with conv2d_gradfix.no_weight_gradients():  # this pass needs the ws gradient only
        (grads,) = torch.autograd.grad((img * y).sum(), ws, create_graph=True)
    lengths = grads.float().square().sum(2).mean(1).sqrt()
    return (lengths - pl_mean).square().mean(), lengths


def _apply_grads(params, grads, opt: torch.optim.Optimizer, group: Group) -> None:
    """Average the gradients over the group's ranks (one flat buffer), hand
    them to the optimizer and step. An unused parameter gets a zero gradient,
    so that every Adam moment decays on every step as optax's does."""
    for p, g in zip(params, all_reduce_grads(group, params, grads)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _ema_params(G: Ide3dGenerator) -> list:
    return list(G.parameters()) + [G.mapping.w_avg]


def make_gan_train_step(tcfg: GanTrainConfig, group: Optional[Group] = None):
    """Returns step(state, batch, generator, ada_p=0.0) -> (state, stats).

    batch: img [B,R,R,3] and seg [B,R,R,19] in the wire format (uint8) or the
    step's, c [B,25], on the state's device: this rank's rows of the global
    batch under a data-parallel `group` (None: this process alone).
    `generator` lives on that device, seeded alike on every rank, and gives
    every draw; ada_p is a host float. The networks and optimizers are updated
    in place; stats are this rank's 0-d device tensors (nothing is read back;
    parallel/stats.StatsAccumulator reduces them over the group). With
    pl_weight > 0, stats also hold pl_penalty (0 off its interval) and
    state.pl_mean follows the mean length."""
    group = group or Group()

    def d_in_for(gen, ada_p):
        return functools.partial(d_input, tcfg=tcfg, gen=gen, ada_p=ada_p)

    @span("gan.g_phase")
    def g_phase(state: GanTrainState, batch, gen, ada_p):
        G, D = state.G, state.D
        z = draw(torch.randn, (batch["img"].shape[0], G.z_dim), generator=gen,
                 device=batch["c"].device)
        D.requires_grad_(False)
        try:
            loss, stats, fakes = g_loss(G, D, z, batch["c"], tcfg, gen, d_in_for(gen, ada_p),
                                        group)
        finally:
            D.requires_grad_(True)
        params = list(G.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        if tcfg.pl_weight > 0:
            pl = torch.zeros((), device=z.device)
            if state.step % PL_INTERVAL == 0:
                ws = map_ws(G, z, batch["c"], tcfg, gen, group)
                pl, lengths = pl_penalty(G, ws, batch["c"], state.pl_mean, gen)
                pl_grads = torch.autograd.grad(pl, params, allow_unused=True)
                scale = tcfg.pl_weight * PL_INTERVAL
                grads = [g if r is None else (r * scale if g is None else g + scale * r)
                         for g, r in zip(grads, pl_grads)]
                mean = group.all_mean(lengths.detach().mean())
                state.pl_mean = state.pl_mean + PL_DECAY * (mean - state.pl_mean)
            stats["pl_penalty"] = pl.detach()
        _apply_grads(params, grads, state.opt_g, group)
        with torch.no_grad():
            w = G.mapping(z, batch["c"])[:, 0]
            G.mapping.w_avg.mul_(tcfg.w_avg_beta).add_(group.all_mean(w.mean(dim=0)),
                                                       alpha=1.0 - tcfg.w_avg_beta)
            ema = _ema_params(state.G_ema)
            torch._foreach_mul_(ema, tcfg.ema_beta)
            torch._foreach_add_(ema, _ema_params(G), alpha=1.0 - tcfg.ema_beta)
        return stats, fakes

    @span("gan.d_phase")
    def d_phase(state: GanTrainState, batch, gen, ada_p, fakes: Optional[Triple]):
        G, D = state.G, state.D
        c = batch["c"]
        if fakes is None:
            z = draw(torch.randn, (c.shape[0], G.z_dim), generator=gen, device=c.device)
            with torch.no_grad():
                fakes = d_triple_fake(synth_fake(G, z, c, tcfg, gen, group))
        real = d_triple_real(batch["img"], batch["seg"], G.cfg.render_size)
        params = list(D.parameters())
        loss, stats = d_loss(D, fakes, real, c, d_in_for(gen, ada_p), group)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        if state.step % tcfg.r1_interval == 0:
            with span("gan.r1"):
                r1 = r1_penalty(D, real, c, d_in_for(gen, ada_p), group)
                r1_grads = torch.autograd.grad(r1, params, allow_unused=True)
            scale = tcfg.r1_gamma / 2.0 * tcfg.r1_interval
            grads = [g if r is None else (r * scale if g is None else g + scale * r)
                     for g, r in zip(grads, r1_grads)]
            stats["r1_penalty"] = r1.detach()
        else:
            stats["r1_penalty"] = torch.zeros((), device=c.device)
        _apply_grads(params, grads, state.opt_d, group)
        return stats

    @span("gan.step")
    @torch.enable_grad()  # whatever grad mode the caller is in
    def step(state: GanTrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             ada_p: float = 0.0):
        batch = expand_compact_batch(batch, state.G.cfg.seg_channels)
        ada_p = float(ada_p)
        with global_draws(group):
            if tcfg.fake_reuse:
                g_stats, fakes = g_phase(state, batch, generator, ada_p)
                d_stats = d_phase(state, batch, generator, ada_p, fakes)
            else:
                d_stats = d_phase(state, batch, generator, ada_p, None)
                g_stats, _ = g_phase(state, batch, generator, ada_p)
        state.step += 1
        return state, {**d_stats, **g_stats}

    return step
