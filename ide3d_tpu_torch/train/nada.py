"""StyleGAN-NADA: text-guided domain adaptation of the generator.

Counterpart of ide3d_tpu/train/nada.py (the reference ships `ide3d-nada` as
an empty submodule; README.md:157-165 describes it). One step:

    L = 1 - cos( E_img(G_train(w)) - E_img(G_frozen(w)),
                 E_txt(target) - E_txt(source) )

with w = G_frozen.mapping(z, c). G_train is a deep copy of G; Adam(2e-3,
betas 0, 0.99) runs over its synthesis parameters. With `freeze_geometry`
(the default) every parameter under the vb plane blocks, the renderer and
the feature volume stays out of the optimizer, which equals the JAX
package's gradient mask: with beta1 = 0 Adam moves a parameter whose gradient
is zero from step 0 by exactly 0. The noise buffers (`noise_const`) stay out
too: both passes draw random noise, so their gradient is 0 in the JAX step.

Both passes take their random draws (layer noise, depth jitter, importance
samples) from one torch.Generator in the same state, as the JAX step feeds
one rng to both: at step 0 the two renders are then equal and the first
loss is exactly 1. The trained pass runs K1 and its backward, the frozen one K1.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class NadaConfig:
    lr: float = 2e-3
    betas: tuple = (0.0, 0.99)
    freeze_geometry: bool = True  # keep vb blocks + renderer frozen


_GEOMETRY = ("renderer", "feature_volume")


def nada_parameters(G, freeze_geometry: bool = True) -> list:
    """(name, parameter) of G.synthesis that NADA trains: all but the noise
    buffers and, with freeze_geometry, all but those under vb*, renderer and
    feature_volume (everything that shapes the rendered volume)."""
    out = []
    for name, p in G.synthesis.named_parameters():
        top = name.split(".", 1)[0]
        if name.rsplit(".", 1)[-1] == "noise_const":
            continue
        if freeze_geometry and (top.startswith("vb") or top in _GEOMETRY):
            continue
        out.append((name, p))
    return out


def init_nada(G, cfg: NadaConfig = NadaConfig()):
    """The trained copy: a deep copy of G with gradients on for NADA's parameters alone."""
    G_train = copy.deepcopy(G).requires_grad_(False)
    for _, p in nada_parameters(G_train, cfg.freeze_geometry):
        p.requires_grad_(True)
    return G_train


def nada_loss(G_train, G_frozen, embed_image: Callable[[torch.Tensor], torch.Tensor],
              tdir: torch.Tensor, z: torch.Tensor, c: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """The directional loss at z [B, z_dim], c [B, 25]; both renders draw
    from `generator` starting at its current state."""
    with torch.no_grad():
        ws = G_frozen.mapping(z, c)
    state = generator.get_state()
    img_t = G_train.synthesis(ws, c, noise_mode="random", generator=generator)
    generator.set_state(state)
    with torch.no_grad():
        e_f = embed_image(G_frozen.synthesis(ws, c, noise_mode="random", generator=generator))
    d = embed_image(img_t) - e_f
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    return (1.0 - d @ tdir).mean()


def make_nada_step(G_train, G_frozen, embed_image: Callable[[torch.Tensor], torch.Tensor],
                   text_direction: torch.Tensor, cfg: NadaConfig = NadaConfig()):
    """step(z, c, generator) -> the loss (detached): one Adam step of
    G_train's NADA parameters, in place."""
    tdir = text_direction / (torch.linalg.vector_norm(text_direction) + 1e-8)
    params = [p for _, p in nada_parameters(G_train, cfg.freeze_geometry)]
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=tuple(cfg.betas), eps=1e-8)

    @torch.enable_grad()
    def step(z: torch.Tensor, c: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        loss = nada_loss(G_train, G_frozen, embed_image, tdir, z, c, generator)
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()
        return loss.detach()

    return step
