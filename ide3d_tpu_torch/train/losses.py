"""Losses of encoder training and inversion.

Counterpart of ide3d_tpu/train/losses.py: w-space smooth-L1, L2, the BiSeNet
per-pixel cross-entropy, a perceptual distance over any list of feature maps
(the VGG19 / pyramid losses) and the ArcFace cosine identity loss. The
perceptual and identity losses take their backbone as a callable, so the
trainers do not depend on which network provides the features. Images and
logits are NHWC.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """torch's smooth L1 (mean reduction), as the JAX package writes it out."""
    return F.smooth_l1_loss(x, y, beta=beta)


def l2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x - y).square().mean()


def cross_entropy_seg(logits: torch.Tensor, target_ids: torch.Tensor) -> torch.Tensor:
    """Mean per-pixel cross-entropy of channels-last logits [B,H,W,C] against
    integer targets [B,H,W]."""
    return F.cross_entropy(logits.permute(0, 3, 1, 2), target_ids.long())


def multiscale_feature_loss(feats_fn: Callable, x: torch.Tensor, y: torch.Tensor,
                            stop_target_grad: bool = True) -> torch.Tensor:
    """Mean over the feature maps of feats_fn of each map's mean squared
    difference; the target's (y's) maps are detached unless asked otherwise."""
    fx, fy = feats_fn(x), feats_fn(y)
    if stop_target_grad:
        fy = [f.detach() for f in fy]
    return sum((a - b).square().mean() for a, b in zip(fx, fy)) / len(fx)


def cosine_id_loss(embed_fn: Callable, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """1 - cos(embed(x), embed(y)), averaged over the batch; the target's embedding is detached."""
    ex, ey = embed_fn(x), embed_fn(y).detach()
    ex = ex / (torch.linalg.vector_norm(ex, dim=-1, keepdim=True) + 1e-8)
    ey = ey / (torch.linalg.vector_norm(ey, dim=-1, keepdim=True) + 1e-8)
    return (1.0 - (ex * ey).sum(dim=-1)).mean()
