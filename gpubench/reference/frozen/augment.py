"""ADA augmentation (StyleGAN2-ADA) for the dual-branch D input, in PyTorch.

Counterpart of ide3d_tpu/train/augment.py, with its transform family:
probability-gated pixel blits (x-flip, 90° rotations, integer translation) and
general geometry (isotropic and anisotropic scale, pre- and post-rotation,
fractional translation) composed into one 3x3 matrix per image and run as ONE
bilinear inverse warp (F.grid_sample's, align_corners=False, zeros padding,
output grid at the pixel centres); brightness, contrast, luma flip, hue and
saturation composed into one 4x4 colour matrix; and cutout. Every draw comes
from an explicit torch.Generator (the JAX package's keys give other numbers),
so `augment_d_input` is split into the draws (`_geometry_matrix`,
`_color_matrix`, `_cutout_mask`) and their deterministic application
(`apply_augment`). The adaptive-p controller (`AdaState`, `ada_accumulate`,
`ada_update`) is host arithmetic, as there.

The warp samples in fp32 whatever the compute dtype: a bf16 sampling grid
would misplace pixels by up to one at 512². `wavelet_aa=True` wraps the warp
in the reference's sym6 wavelet anti-aliasing as the JAX package runs it
(`_apply_warp_wavelet`): reflect pad by a fixed margin, 2x sym6 upsample, the
warp on the 2x grid, sym6 downsample with a crop, in fp32, the whole batch at
once (the JAX package maps over the images only to fit a TPU's memory). The
warp is `ops.grid_sample.sample_bilinear`, which differentiates twice (R1).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .blocks import DTYPES
from .grid_sample import sample_bilinear
from .upfirdn2d import downsample2d, setup_filter, upsample2d
from ._mesh import Group, draw

# Orthogonal wavelet decomposition low-pass: the public sym6 coefficients, as
# the reference registers them for its geometric anti-aliasing.
WAVELET_SYM6 = (
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
)
# Reflect-pad margin of the wavelet warp as a fraction of the image width (the
# reference computes it per batch from the transformed corners).
WAVELET_MARGIN = 0.125


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    # probabilities multiply the global p (reference defaults)
    xflip: float = 1.0
    rotate90: float = 1.0
    xint: float = 1.0
    xint_max: float = 0.125
    scale: float = 1.0
    rotate: float = 1.0
    aniso: float = 1.0
    xfrac: float = 1.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 1.0
    contrast: float = 1.0
    lumaflip: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    cutout: float = 0.0
    cutout_size: float = 0.5
    wavelet_aa: bool = False  # sym6 wavelet anti-aliasing around the warp (~4x its cost)
    # dtype of the augmented stack; D casts its input to its own dtype anyway
    compute_dtype: str = "bfloat16"


def _rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    return draw(torch.rand, shape, generator=gen, device=device)


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return draw(torch.randn, shape, generator=gen, device=device)


def _bernoulli(gen: torch.Generator, p: float, shape, device) -> torch.Tensor:
    return (_rand(gen, shape, device) < p).float()


def _rot2d(theta: torch.Tensor) -> torch.Tensor:
    c, s, z, o = torch.cos(theta), torch.sin(theta), torch.zeros_like(theta), torch.ones_like(theta)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _translate2d(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return torch.stack([torch.stack([o, z, tx], -1), torch.stack([z, o, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def _scale2d(sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, z], -1), torch.stack([z, sy, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _geometry_matrix(gen: torch.Generator, p: float, cfg: AugmentConfig, B: int, W: int, H: int,
                     device=None) -> torch.Tensor:
    """Per-image forward geometry matrix [B,3,3] in [-1,1] image coordinates."""
    Gm = torch.eye(3, device=device).expand(B, 3, 3)
    ones = torch.ones(B, device=device)
    if cfg.xflip > 0:
        w = _bernoulli(gen, cfg.xflip * p, (B,), device)
        Gm = _scale2d(1.0 - 2.0 * w, ones) @ Gm
    if cfg.rotate90 > 0:
        w = _bernoulli(gen, cfg.rotate90 * p, (B,), device)
        k = draw(functools.partial(torch.randint, 0, 4), (B,), generator=gen,
                 device=device).float() * w
        Gm = _rot2d(-k * (math.pi / 2)) @ Gm
    if cfg.xint > 0:
        # ONE Bernoulli gates both translation axes, as in the reference
        w = _bernoulli(gen, cfg.xint * p, (B, 1), device)
        t = (_rand(gen, (B, 2), device) * 2 - 1) * cfg.xint_max * w
        wh = torch.tensor([W, H], dtype=torch.float32, device=device)
        t = torch.round(t * wh / 2.0) * 2.0 / wh
        Gm = _translate2d(t[:, 0], t[:, 1]) @ Gm
    if cfg.scale > 0:
        w = _bernoulli(gen, cfg.scale * p, (B,), device)
        s = torch.exp2(_randn(gen, (B,), device) * cfg.scale_std * w)
        Gm = _scale2d(s, s) @ Gm
    if cfg.rotate > 0 or cfg.aniso > 0:
        # pre-rotation -> aniso -> post-rotation, each rotation with
        # p_rot = 1 - sqrt(1 - rotate*p), so P(any rotation) = rotate*p
        p_rot = 1.0 - math.sqrt(min(max(1.0 - cfg.rotate * p, 0.0), 1.0))

        def rotation(Gm):
            w = (_rand(gen, (B,), device) < p_rot).float()
            theta = (_rand(gen, (B,), device) * 2 - 1) * math.pi * cfg.rotate_max * w
            return _rot2d(-theta) @ Gm

        if cfg.rotate > 0:
            Gm = rotation(Gm)
        if cfg.aniso > 0:
            w = _bernoulli(gen, cfg.aniso * p, (B,), device)
            s = torch.exp2(_randn(gen, (B,), device) * cfg.aniso_std * w)
            Gm = _scale2d(s, 1.0 / s) @ Gm
        if cfg.rotate > 0:
            Gm = rotation(Gm)
    if cfg.xfrac > 0:
        w = _bernoulli(gen, cfg.xfrac * p, (B, 1), device)  # one gate, both axes
        t = _randn(gen, (B, 2), device) * cfg.xfrac_std * w
        Gm = _translate2d(t[:, 0], t[:, 1]) @ Gm
    return Gm


def _color_matrix(gen: torch.Generator, p: float, cfg: AugmentConfig, B: int,
                  device=None) -> torch.Tensor:
    """Per-image 4x4 colour matrix."""
    eye4 = torch.eye(4, device=device)
    Cm = eye4.expand(B, 4, 4)
    v = torch.tensor([1.0, 1.0, 1.0, 0.0], device=device) / math.sqrt(3)  # luma axis
    vvT = torch.outer(v, v)
    if cfg.brightness > 0:
        w = _bernoulli(gen, cfg.brightness * p, (B,), device)
        b = _randn(gen, (B,), device) * cfg.brightness_std * w
        M = eye4.repeat(B, 1, 1)
        M[:, :3, 3] += b[:, None]
        Cm = M @ Cm
    if cfg.contrast > 0:
        w = _bernoulli(gen, cfg.contrast * p, (B,), device)
        cs = torch.exp2(_randn(gen, (B,), device) * cfg.contrast_std * w)
        Cm = torch.diag_embed(torch.stack([cs, cs, cs, torch.ones_like(cs)], -1)) @ Cm
    if cfg.lumaflip > 0:
        w = _bernoulli(gen, cfg.lumaflip * p, (B,), device)
        Cm = (eye4 - 2.0 * vvT * w[:, None, None]) @ Cm
    if cfg.hue > 0:
        w = _bernoulli(gen, cfg.hue * p, (B,), device)
        theta = (_rand(gen, (B,), device) * 2 - 1) * math.pi * cfg.hue_max * w
        vv = v[:3]
        K = torch.stack([torch.stack([0 * vv[0], -vv[2], vv[1]]),
                         torch.stack([vv[2], 0 * vv[0], -vv[0]]),
                         torch.stack([-vv[1], vv[0], 0 * vv[0]])])
        R3 = (torch.eye(3, device=device) + torch.sin(theta)[:, None, None] * K
              + (1 - torch.cos(theta))[:, None, None] * (K @ K))  # Rodrigues, luma axis
        M = eye4.repeat(B, 1, 1)
        M[:, :3, :3] = R3
        Cm = M @ Cm
    if cfg.saturation > 0:
        w = _bernoulli(gen, cfg.saturation * p, (B,), device)
        s = torch.exp2(_randn(gen, (B,), device) * cfg.saturation_std * w)
        Cm = (vvT + (eye4 - vvT) * s[:, None, None]) @ Cm
    return Cm


def _cutout_mask_at(center: torch.Tensor, gate: torch.Tensor, size: float, H: int,
                    W: int) -> torch.Tensor:
    """Keep-mask [B,H,W]: 0 inside a size x size square at `center` [B,2]
    ((y, x) in [0,1]) where `gate` [B] is 1, else 1."""
    dev = center.device
    ys = torch.linspace(0, 1, H, device=dev)[None, :, None]
    xs = torch.linspace(0, 1, W, device=dev)[None, None, :]
    mask_y = ((ys - center[:, 0, None, None]).abs() >= size / 2).float()
    mask_x = ((xs - center[:, 1, None, None]).abs() >= size / 2).float()
    return torch.maximum(torch.maximum(mask_y, mask_x), 1.0 - gate[:, None, None])


def _cutout_mask(gen: torch.Generator, p: float, cfg: AugmentConfig, B: int, H: int, W: int,
                 device=None) -> torch.Tensor:
    gate = _bernoulli(gen, cfg.cutout * p, (B,), device)
    return _cutout_mask_at(_rand(gen, (B, 2), device), gate, cfg.cutout_size, H, W)


def _sample_affine(images: torch.Tensor, A: torch.Tensor, Ho: int, Wo: int) -> torch.Tensor:
    """Bilinear-sample NHWC `images` on an [Ho, Wo] grid of pixel centres
    through the per-image inverse matrix A [B,3,3] (output -> input normalized
    coordinates, align_corners=False, zeros padding); fp32 inside, returned in
    the images' dtype."""
    B = images.shape[0]
    dev = images.device
    ys = (torch.arange(Ho, device=dev) * 2.0 + 1.0) / Ho - 1.0
    xs = (torch.arange(Wo, device=dev) * 2.0 + 1.0) / Wo - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(1, Ho * Wo, 3)
    src = torch.einsum("bij,bnj->bni", A.float().detach(), grid.expand(B, -1, -1))
    out = sample_bilinear(images.permute(0, 3, 1, 2).float().contiguous(),
                          src[..., :2].reshape(B, Ho, Wo, 2).contiguous(), align_corners=False)
    return out.permute(0, 2, 3, 1).to(images.dtype)


def _apply_warp(images: torch.Tensor, Gm: torch.Tensor,
                cfg: Optional[AugmentConfig] = None) -> torch.Tensor:
    """Run the inverse of the geometry matrix once: bilinear, zeros padding;
    with cfg.wavelet_aa, inside the sym6 up/down filtering."""
    _, H, W, _ = images.shape
    Ginv = torch.linalg.inv(Gm.float())
    if cfg is not None and cfg.wavelet_aa:
        return _apply_warp_wavelet(images, Ginv)
    return _sample_affine(images, Ginv, H, W)


def _diag3(a: float, b: float, device) -> torch.Tensor:
    return torch.diag(torch.tensor([a, b, 1.0], device=device))


def _apply_warp_wavelet(images: torch.Tensor, Ginv: torch.Tensor) -> torch.Tensor:
    """The reference's anti-aliased warp, as the JAX package's
    `_apply_warp_wavelet`: reflect pad by m = ceil(WAVELET_MARGIN * max(H, W))
    + 2 hz (at most min(H, W) - 1), 2x sym6 upsample, the inverse matrix
    Ginv [B,3,3] (normalized coordinates) conjugated into centred pixels,
    scaled to the 2x grid with its half-pixel shift, the bilinear warp onto
    the [(H + 2 hz) * 2]² grid, then the sym6 downsample that crops back to
    H x W. In fp32; returned in the images' dtype."""
    B, H, W, C = images.shape
    dev = images.device
    f = setup_filter(WAVELET_SYM6)
    hz = len(WAVELET_SYM6) // 4
    m = min(int(math.ceil(WAVELET_MARGIN * max(H, W))) + 2 * hz, min(H, W) - 1)
    x = F.pad(images.permute(0, 3, 1, 2).float(), (m, m, m, m), mode="reflect")
    x = upsample2d(x, f, up=2)  # [B, C, (H + 2m) * 2, (W + 2m) * 2]
    G1 = _diag3(W / 2.0, H / 2.0, dev) @ Ginv.float() @ _diag3(2.0 / W, 2.0 / H, dev)
    G1 = _diag3(2.0, 2.0, dev) @ G1 @ _diag3(0.5, 0.5, dev)
    G1 = _translate2d(*torch.full((2, 1), -0.5, device=dev)) @ G1 \
        @ _translate2d(*torch.full((2, 1), 0.5, device=dev))
    Ho, Wo = (H + 2 * hz) * 2, (W + 2 * hz) * 2
    Hi, Wi = x.shape[2], x.shape[3]
    A = _diag3(2.0 / Wi, 2.0 / Hi, dev) @ G1 @ _diag3(Wo / 2.0, Ho / 2.0, dev)
    y = _sample_affine(x.permute(0, 2, 3, 1), A, Ho, Wo)
    y = downsample2d(y.permute(0, 3, 1, 2), f, down=2, padding=-hz * 2, flip_filter=True)
    return y.permute(0, 2, 3, 1).to(images.dtype)


def _apply_color(images: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """Apply the 4x4 colour matrix to a 3-channel NHWC stack, in its dtype."""
    if images.shape[-1] != 3:
        raise ValueError(f"colour transforms take 3 channels, got {images.shape[-1]}")
    Cm = Cm.to(images.dtype)
    return torch.einsum("bij,bhwj->bhwi", Cm[:, :3, :3], images) + Cm[:, None, None, :3, 3]


def apply_augment(img: torch.Tensor, img_raw: torch.Tensor, seg: torch.Tensor, Gm: torch.Tensor,
                  Cm: torch.Tensor, mask: Optional[torch.Tensor],
                  cfg: AugmentConfig = AugmentConfig()) -> Tuple[torch.Tensor, ...]:
    """The deterministic half of `augment_d_input`: the same warp Gm [B,3,3] on
    all three stacks, the colour matrix Cm [B,4,4] on the two RGB stacks, the
    keep-mask [B,H,W] (or None) on everything, in cfg.compute_dtype."""
    dt = DTYPES[cfg.compute_dtype]
    stack = torch.cat([img.to(dt), img_raw.to(dt), seg.to(dt)], dim=-1)
    stack = _apply_warp(stack, Gm, cfg)
    img, img_raw, seg = stack[..., :3], stack[..., 3:6], stack[..., 6:]
    img, img_raw = _apply_color(img, Cm), _apply_color(img_raw, Cm)
    if mask is not None:
        m = mask[..., None].to(dt)
        img, img_raw, seg = img * m, img_raw * m, seg * m
    return img, img_raw, seg


def augment_d_input(
    gen: torch.Generator,
    img: torch.Tensor,  # [B, R, R, 3] final RGB in [-1, 1]
    img_raw: torch.Tensor,  # [B, R, R, 3] upsampled raw-render RGB
    seg: torch.Tensor,  # [B, R, R, S] semantic channels
    p: float,
    cfg: AugmentConfig = AugmentConfig(),
) -> Tuple[torch.Tensor, ...]:
    """ADA at probability p for the dual-branch, seg-conditioned D input: one
    draw of the geometry, colour and cutout per sample from `gen`, applied by
    `apply_augment`. Called for real and fake inputs alike."""
    B, H, W, _ = img.shape
    dev = img.device
    Gm = _geometry_matrix(gen, p, cfg, B, W, H, dev)
    Cm = _color_matrix(gen, p, cfg, B, dev)
    mask = _cutout_mask(gen, p, cfg, B, H, W, dev) if cfg.cutout > 0 else None
    return apply_augment(img, img_raw, seg, Gm, Cm, mask, cfg)


class AdaState(NamedTuple):
    """Adaptive-p controller state, host floats: heuristic rt = E[sign(D(real))]
    held at `target`, p nudged by batch / (speed_kimg * 1000) per update."""

    p: float
    rt_accum: tuple  # (sum of signs, count)


def ada_init() -> AdaState:
    return AdaState(p=0.0, rt_accum=(0.0, 0.0))


def ada_accumulate(state: AdaState, sign_mean, n, group: Optional[Group] = None) -> AdaState:
    """Add one batch's per-sample sign statistic: sign_mean = mean over the
    batch's n samples of sign(D(real)) (the step's stats['real_signs']). Under
    a data-parallel `group`, sign_mean is this rank's 0-d tensor, n the global
    batch, and the mean over the ranks is added, so p moves alike on every
    rank (a collective: every rank calls it)."""
    if group is not None:
        sign_mean = group.all_mean(torch.as_tensor(sign_mean, device=group.device))
    a = np.asarray(state.rt_accum, np.float64)
    return state._replace(rt_accum=(float(a[0]) + float(sign_mean) * n, float(a[1]) + float(n)))


def ada_update(state: AdaState, batch_size: int, target: float = 0.6,
               speed_kimg: float = 500.0, p_max: float = 1.0) -> AdaState:
    """One controller step; p is clamped to [0, p_max] (p_max bounds the leak
    when D memorizes a small dataset and rt pins above the target)."""
    a = np.asarray(state.rt_accum, np.float64)
    rt = float(a[0]) / max(float(a[1]), 1.0)
    sgn = (rt > target) - (rt < target)
    adjust = sgn * batch_size / (speed_kimg * 1000.0)
    p = min(max(float(state.p) + adjust, 0.0), p_max)
    return AdaState(p=p, rt_accum=(0.0, 0.0))
