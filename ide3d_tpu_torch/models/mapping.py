"""Mapping network z (+ camera label c) -> w+.

Counterpart of ide3d_tpu/models/mapping.py: an 8-layer lr=0.01 MLP on the
2nd-moment-normalized latent with a label embedding, w broadcast to num_ws
rows, and truncation toward the tracked w_avg with an optional cutoff. The
label embedding is w_dim wide unless `embed_features` says otherwise (TF1-era
StyleGAN2 pickles' `label_fmaps`). With
num_ws=None (the discriminator's label mapping, z_dim=0) nothing is broadcast
and there is no w_avg, as that tree has none.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import FullyConnectedLayer


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class MappingNetwork(nn.Module):
    def __init__(self, z_dim: int = 512, c_dim: int = 25, w_dim: int = 512,
                 num_ws: Optional[int] = 18, num_layers: int = 8,
                 embed_features: Optional[int] = None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        embed = (w_dim if embed_features is None else embed_features) if c_dim > 0 else 0
        features = [z_dim + embed] + [w_dim] * self.num_layers
        for i in range(self.num_layers):
            setattr(self, f"fc{i}", FullyConnectedLayer(
                features[i], features[i + 1], activation="lrelu", lr_multiplier=0.01))
        self.embed = FullyConnectedLayer(c_dim, embed) if c_dim > 0 else None
        if num_ws is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(
        self,
        z: Optional[torch.Tensor],
        c: Optional[torch.Tensor] = None,
        truncation_psi: float = 1.0,
        truncation_cutoff: Optional[int] = None,
        broadcast: bool = True,
    ) -> torch.Tensor:
        """-> ws [B, num_ws, w_dim], truncated toward w_avg (rows < cutoff only,
        when a cutoff is given); w [B, w_dim] when num_ws is None or not `broadcast`."""
        x = None
        if self.z_dim > 0:
            if z is None or z.shape[-1] != self.z_dim:
                raise ValueError(f"z must be [B, {self.z_dim}]")
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            if c is None or c.shape[-1] != self.c_dim:
                raise ValueError(f"c must be [B, {self.c_dim}]")
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=-1) if x is not None else y

        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)

        if self.num_ws is None:
            return x
        if broadcast:
            x = x[:, None, :].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            if truncation_cutoff is None or not broadcast:
                x = self.w_avg + (x - self.w_avg) * truncation_psi
            else:
                head = self.w_avg + (x[:, :truncation_cutoff] - self.w_avg) * truncation_psi
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x
