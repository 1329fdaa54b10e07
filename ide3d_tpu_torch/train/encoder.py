"""Hybrid-encoder training: one step covering both of the reference's branches.

Counterpart of ide3d_tpu/train/encoder.py (the reference's
apps/train_hybrid_encoder.py loop):
  * synthetic branch: z -> G -> (image, BiSeNet pseudo-mask) -> E ->
    50 x smooth-L1 on the w+ codes, L2 on the reconstruction, cross-entropy of
    BiSeNet's parse of the reconstruction against its parse of the image, and
    the cycle smooth-L1 of the code re-encoded from the reconstruction's mask;
  * real branch: the dataset's (image, seg, label) -> E -> G -> L2, the
    perceptual (VGG19 feature maps), LPIPS and ArcFace identity losses,
    cross-entropy and cycle as above.

Both branches enter one loss and one backward. G and BiSeNet are frozen (the
gradient is taken for E's parameters only); E trains with Adam(1e-4, betas
0.9 / 0.99). The perceptual, LPIPS and identity losses are callbacks (None:
off). Without BiSeNet the synthetic branch takes its pseudo-mask from G's own
seg. Under a data-parallel group (parallel/mesh.py) the batch is this rank's
rows of the global batch, z is drawn at the global shape and sliced, and E's
gradients are averaged over the ranks as one flat buffer: every loss is a
per-sample mean, so the step is the JAX step over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..models.encoder import HybridEncoder
from ..models.generator import Ide3dGenerator
from ..parallel.mesh import Group, all_reduce_grads, draw, global_draws
from ..utils.seg import id_remap
from . import losses as L
from .gan import expand_compact_batch


@dataclasses.dataclass(frozen=True)
class EncoderTrainConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.99
    w_ws: float = 50.0
    w_l2: float = 1.0
    w_entropy: float = 1.0
    w_cycle: float = 1.0
    w_vgg: float = 1.0
    w_lpips: float = 1.0
    w_id: float = 1.0
    truncation: float = 1.0
    train_gen: bool = True  # synthetic branch
    train_real: bool = True  # real branch


@dataclasses.dataclass
class EncoderTrainState:
    step: int
    E: HybridEncoder
    opt_e: torch.optim.Optimizer


def init_encoder_state(E: HybridEncoder, tcfg: EncoderTrainConfig) -> EncoderTrainState:
    """Step 0 and a fresh Adam around an initialised E (on its device)."""
    return EncoderTrainState(0, E, torch.optim.Adam(E.parameters(), lr=tcfg.lr,
                                                    betas=(tcfg.beta1, tcfg.beta2), eps=1e-8))


def _parse(bisenet, img: torch.Tensor):
    """BiSeNet's parse: (20-class logits, remapped 19-class one-hot in {-1, 1})."""
    logits = bisenet(img)
    onehot = F.one_hot(id_remap(logits.argmax(dim=-1)), 19).float()
    return logits, onehot * 2.0 - 1.0


def encoder_loss(E: HybridEncoder, G: Ide3dGenerator, tcfg: EncoderTrainConfig,
                 batch: Dict[str, torch.Tensor], z: Optional[torch.Tensor],
                 bisenet: Optional[Callable] = None, vgg_feats: Optional[Callable] = None,
                 lpips_fn: Optional[Callable] = None, id_embed: Optional[Callable] = None):
    """(total, stats) of one step at the given z [B, z_dim] (the synthetic
    branch's draw). batch: c [B, 25], and img, seg (wire or step format) for
    the real branch. Renders are deterministic (noise const, no generator)."""
    batch = expand_compact_batch(batch, G.cfg.seg_channels)
    stats: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), device=batch["c"].device)
    w_avg = G.mapping.w_avg[None, None]

    def encode(img, seg):
        return E(img, seg) + w_avg  # E predicts the offset from w_avg

    def add(name, value):
        nonlocal total
        stats[name] = value.detach()
        total = total + value

    if tcfg.train_gen:
        c = batch["c"]
        with torch.no_grad():
            w_samples = G.mapping(z, c)
            if tcfg.truncation < 1.0:
                w_samples = w_avg + (w_samples - w_avg) * tcfg.truncation
            gen_img, gen_seg = G.synthesis(w_samples, c, return_seg=True)
            if bisenet is not None:
                gen_logits, gen_seg_pm = _parse(bisenet, gen_img)
                gen_ids20 = gen_logits.argmax(dim=-1)
            else:  # no face parser: the generator's own seg, one-hot in {-1, 1}
                gen_seg_pm = F.one_hot(gen_seg.argmax(dim=-1), gen_seg.shape[-1]).float() * 2.0 - 1.0
        rec_ws = encode(gen_img, gen_seg_pm)
        add("loss_ws", L.smooth_l1(rec_ws, w_samples) * tcfg.w_ws)
        rec_img = G.synthesis(rec_ws, c)
        add("loss_gen_l2", L.l2(rec_img, gen_img) * tcfg.w_l2)
        if bisenet is not None:
            rec_logits, rec_seg_pm = _parse(bisenet, rec_img)
            add("loss_gen_entropy", L.cross_entropy_seg(rec_logits, gen_ids20) * tcfg.w_entropy)
            cyc_ws = encode(gen_img, rec_seg_pm.detach())
            add("loss_cycle", L.smooth_l1(rec_ws.detach(), cyc_ws) * tcfg.w_cycle)

    if tcfg.train_real and "img" in batch:
        real_img, real_seg, real_c = batch["img"], batch["seg"], batch["c"]
        rec_ws = encode(real_img, real_seg)
        rec_img = G.synthesis(rec_ws, real_c)
        add("loss_real_l2", L.l2(rec_img, real_img) * tcfg.w_l2)
        if vgg_feats is not None:
            add("loss_vgg", L.multiscale_feature_loss(vgg_feats, rec_img, real_img) * tcfg.w_vgg)
        if lpips_fn is not None:
            add("loss_lpips", lpips_fn(rec_img, real_img.detach()).mean() * tcfg.w_lpips)
        if id_embed is not None:
            add("loss_id", L.cosine_id_loss(id_embed, rec_img, real_img) * tcfg.w_id)
        if bisenet is not None:
            with torch.no_grad():
                real_ids = bisenet(real_img).argmax(dim=-1)
            rec_logits, rec_seg_pm = _parse(bisenet, rec_img)
            add("loss_real_entropy", L.cross_entropy_seg(rec_logits, real_ids) * tcfg.w_entropy)
            cyc_ws = encode(real_img, rec_seg_pm.detach())
            add("loss_real_cycle", L.smooth_l1(rec_ws.detach(), cyc_ws) * tcfg.w_cycle)

    stats["loss_total"] = total.detach()
    return total, stats


def make_encoder_train_step(E: HybridEncoder, G: Ide3dGenerator, tcfg: EncoderTrainConfig,
                            bisenet: Optional[Callable] = None, vgg_feats: Optional[Callable] = None,
                            lpips_fn: Optional[Callable] = None, id_embed: Optional[Callable] = None,
                            group: Optional[Group] = None):
    """Returns step(state, batch, generator) -> (state, stats): z drawn from
    `generator` (on the batch's device), encoder_loss, E's gradient averaged
    over `group` (None: this process alone), Adam. stats are this rank's 0-d
    device tensors (nothing is read back)."""
    params = list(E.parameters())
    group = group or Group()

    @torch.enable_grad()
    def step(state: EncoderTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None):
        c = batch["c"]
        with global_draws(group):
            z = draw(torch.randn, (c.shape[0], G.z_dim), generator=generator, device=c.device)
        total, stats = encoder_loss(state.E, G, tcfg, batch, z, bisenet, vgg_feats, lpips_fn,
                                    id_embed)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # an unused parameter's moments still decay, as optax's
        for p, g in zip(params, all_reduce_grads(group, params, grads)):
            p.grad = g
        state.opt_e.step()
        state.opt_e.zero_grad(set_to_none=True)
        state.step += 1
        return state, stats

    return step
