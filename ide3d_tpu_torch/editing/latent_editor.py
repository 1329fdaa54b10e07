"""Latent editing: GANSpace PCA, InterFaceGAN directions, the StyleCLIP mapper.

Counterpart of ide3d_tpu/editing/latent_editor.py, with its contracts:
  * GANSpace (inversion/editings/ganspace.py:1-21): per direction
    (component_idx, start_layer, end_layer, strength), shift the chosen w+
    rows along a PCA component of the w distribution,
  * InterFaceGAN (inversion/editings/latent_editor.py:9-23): ws + alpha * direction,
  * the StyleCLIP LevelsMapper (inversion/scripts/pti_styleclip.py:7-57):
    three 4-layer MLP mappers over the coarse (0:4), medium (4:8) and fine
    (8:) w+ groups, ws' = ws + 0.1 * mapper(ws); the module has only the
    groups in use, under the reference's names (`course`, sic).
GANSpace's z comes from a torch.Generator (the JAX package draws with
jax.random: the same distribution, not the same numbers; `z=` takes given
draws). The PCA itself is numpy on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.layers import FullyConnectedLayer, init_seeded
from ..models.mapping import normalize_2nd_moment
from ..render.camera import CANONICAL_POSE_25

# --------------------------------------------------------------------- GANSpace


@torch.no_grad()
def compute_ganspace_pca(G, n_samples: int = 10000, generator: Optional[torch.Generator] = None,
                         n_components: int = 80, z: Optional[torch.Tensor] = None) -> dict:
    """PCA of the w distribution (the GANSpace procedure): n_samples z (from
    `generator`, seed 0 on G's device when None; or the given `z`) mapped at
    the canonical pose without broadcast. Returns numpy 'comp' [n_components,
    w_dim], 'mean' [w_dim], 'std' [n_components]."""
    dev = G.mapping.w_avg.device
    if z is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        z = torch.randn(n_samples, G.z_dim, generator=generator, device=dev)
    z = z.to(dev)
    c = torch.as_tensor(CANONICAL_POSE_25, device=dev)[None].expand(z.shape[0], -1)
    ws = G.mapping(z, c, broadcast=False).float().cpu().numpy()
    mean = ws.mean(axis=0)
    _, s, vt = np.linalg.svd(ws - mean, full_matrices=False)
    return {"comp": vt[:n_components], "mean": mean,
            "std": s[:n_components] / np.sqrt(len(ws) - 1)}


def apply_ganspace_edit(latents: torch.Tensor, pca: dict,
                        edit_directions: Sequence[Tuple[int, int, int, float]]) -> torch.Tensor:
    """latents [B, num_ws, w_dim]; for each (pca_idx, start, end, strength) the
    component times strength is added to rows [start:end) (ganspace.py:4-21)."""
    comp = torch.as_tensor(pca["comp"], dtype=latents.dtype, device=latents.device)
    edit = torch.zeros_like(latents)
    for pca_idx, start, end, strength in edit_directions:
        edit[:, start:end] += comp[pca_idx] * strength
    return latents + edit


# ----------------------------------------------------------------- InterFaceGAN


def apply_interfacegan(latents: torch.Tensor, direction: torch.Tensor, factor: float = 1.0):
    """latent_editor.py:13-16."""
    return latents + factor * direction


def interfacegan_factor_range(latents, direction, factor_range):
    """The range variant (latent_editor.py:17-23): one edit per factor of range(*factor_range)."""
    return [latents + f * direction for f in range(*factor_range)]


# -------------------------------------------------------------------- StyleCLIP


class _Mapper(nn.Module):
    """StyleCLIP's Mapper: PixelNorm + 4 x EqualLinear(lr_mul 0.01, fused lrelu)."""

    def __init__(self, w_dim: int):
        super().__init__()
        for j in range(4):
            setattr(self, f"fc{j}", FullyConnectedLayer(w_dim, w_dim, activation="lrelu",
                                                        lr_multiplier=0.01))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # StyleCLIP's PixelNorm normalizes dim=1 (model.py:15-16): for the
        # mapper's [B, n_rows, 512] input that is the ROW axis, not channels.
        # Kept as it is for pretrained-mapper parity.
        x = normalize_2nd_moment(x, dim=1)
        for j in range(4):
            x = getattr(self, f"fc{j}")(x)
        return x


_GROUPS = (("course", "use_coarse"), ("medium", "use_medium"), ("fine", "use_fine"))


class LevelsMapper(nn.Module):
    """StyleCLIP LevelsMapper: independent 4-layer (PixelNorm + FC-lrelu)
    mappers for the coarse (rows 0:4), medium (4:8) and fine (8:) w+ groups;
    edit = w + 0.1 * mapper(w). A group not in use has no module and a zero delta."""

    def __init__(self, w_dim: int = 512, num_ws: int = 18, use_coarse: bool = True,
                 use_medium: bool = True, use_fine: bool = True):
        super().__init__()
        self.w_dim, self.num_ws = w_dim, num_ws
        self.use_coarse, self.use_medium, self.use_fine = use_coarse, use_medium, use_fine
        for name, flag in _GROUPS:
            if getattr(self, flag):
                setattr(self, name, _Mapper(w_dim))

    def init(self, seed: int = 0) -> "LevelsMapper":
        """Seeded weights (normal / lr_mul weights, zero biases), drawn on the
        CPU as Ide3dGenerator.init. Returns self."""
        return init_seeded(self, seed)

    def forward(self, ws: torch.Tensor) -> torch.Tensor:
        """ws [B, num_ws, w_dim] -> delta [B, num_ws, w_dim]."""
        parts = []
        for (name, flag), rows in zip(_GROUPS, (ws[:, :4], ws[:, 4:8], ws[:, 8:])):
            parts.append(getattr(self, name)(rows) if getattr(self, flag) else torch.zeros_like(rows))
        return torch.cat(parts, dim=1)

    def edit(self, ws: torch.Tensor, strength: float = 0.1) -> torch.Tensor:
        return ws + strength * self(ws)


# The 14 named attribute edits the reference ships pretrained mappers for
# (inversion/scripts/pti_styleclip.py:7-23): edit name -> (mapper checkpoint id,
# no_coarse, no_medium, no_fine).
STYLECLIP_EDITS = {
    "afro": ("afro", False, False, True),
    "angry": ("angry", False, False, True),
    "Beyonce": ("beyonce", False, False, False),
    "bobcut": ("bobcut", False, False, True),
    "bowlcut": ("bowlcut", False, False, True),
    "curly hair": ("curly_hair", False, False, True),
    "Hilary Clinton": ("hilary_clinton", False, False, False),
    "Jhonny Depp": ("depp", False, False, False),
    "mohawk": ("mohawk", False, False, True),
    "purple hair": ("purple_hair", False, False, False),
    "surprised": ("surprised", False, False, True),
    "Taylor Swift": ("taylor_swift", False, False, False),
    "trump": ("trump", False, False, False),
    "Mark Zuckerberg": ("zuckerberg", False, False, False),
}


def levels_mapper_for_edit(edit_name: str, num_ws: int = 18, w_dim: int = 512) -> LevelsMapper:
    """LevelsMapper configured as pti_styleclip.py configures it for a named edit."""
    _, no_coarse, no_medium, no_fine = STYLECLIP_EDITS[edit_name]
    return LevelsMapper(w_dim=w_dim, num_ws=num_ws, use_coarse=not no_coarse,
                        use_medium=not no_medium, use_fine=not no_fine)


def import_levels_mapper(sd: Dict[str, Union[torch.Tensor, np.ndarray]],
                         num_ws: int = 18) -> LevelsMapper:
    """A pretrained StyleCLIP mapper's state dict -> LevelsMapper (CPU, fp32).

    The torch layout (StyleCLIP latent_mappers.py: Mapper = PixelNorm + 4 x
    EqualLinear(512, 512, lr_mul=0.01, 'fused_lrelu')) has the keys
    `[mapper.]{course,medium,fine}_mapping.mapping.{1..4}.{weight,bias}`.
    EqualLinear stores unit-variance / lr_mul weights and applies the bias
    times lr_mul, as FullyConnectedLayer does, so the tensors map 1:1 (both
    [out, in]). The groups present set the use flags; w_dim is the weights'."""
    sd = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v
          for k, v in sd.items() if hasattr(v, "shape")}
    if any(k.startswith("mapper.") for k in sd):
        sd = {k[len("mapper."):]: v for k, v in sd.items() if k.startswith("mapper.")}
    groups = {k.split("_mapping.")[0] for k in sd}
    w_dim = next(v.shape[0] for k, v in sd.items() if k.endswith(".bias"))
    mapper = LevelsMapper(w_dim=w_dim, num_ws=num_ws, use_coarse="course" in groups,
                          use_medium="medium" in groups, use_fine="fine" in groups)
    mapper.load_state_dict({f"{g}.fc{i - 1}.{leaf}": sd[f"{g}_mapping.mapping.{i}.{leaf}"].float()
                            for g in groups for i in range(1, 5) for leaf in ("weight", "bias")})
    return mapper
