"""Equivariance metrics EQ-T / EQ-R (contract: metrics/equivariance.py:192-260).

Counterpart of ide3d_tpu/metrics/equivariance.py. The input-side transform
acts on the camera:
  * EQ-T: a principal-point shift by an integer number of render pixels
    (RenderParams.pixel_offset) against rolling the raw render,
  * EQ-R: rolling the camera about its view axis against rotating the raw
    render (bilinear, zeros padding, align_corners=False) inside a 0.8 disc.
PSNR over the valid region, in dB, 10 log10(4 / mse) for [-1, 1] images.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..render.camera import CANONICAL_POSE_25, make_label_25
from .metric_utils import MetricOptions


def _psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mse = (a - b).square().mean()
    return 10.0 * torch.log10(4.0 / mse.clamp_min(1e-10))


def _roll_matrix(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def _canonical(opts: MetricOptions) -> torch.Tensor:
    return torch.as_tensor(np.asarray(CANONICAL_POSE_25, np.float32), device=opts.device)[None]


def eqt_psnr(G, z: torch.Tensor, c: torch.Tensor, shift_px: int) -> torch.Tensor:
    """The EQ-T PSNR of one latent (a 0-d tensor)."""
    rsz = G.cfg.render_size
    rp0 = G.cfg.render
    rp1 = dataclasses.replace(rp0, pixel_offset=(shift_px * 2.0 / (rsz - 1), 0.0))
    ws = G.mapping(z, c)
    out0 = G.synthesis(ws, c, render_params=rp0, return_raw=True)[1]
    out1 = G.synthesis(ws, c, render_params=rp1, return_raw=True)[1]
    # Shifting the image plane by +dx NDC shows the content dx to the right:
    # out1 is out0 shifted left by shift_px.
    ref = torch.roll(out0, -shift_px, dims=2)
    return _psnr(ref[:, :, : rsz - shift_px], out1[:, :, : rsz - shift_px])


def compute_eqt(opts: MetricOptions, shift_px: int = 4) -> float:
    """Translation equivariance of the neural render (integer-pixel variant)."""
    G = opts.G
    rs = np.random.RandomState(opts.seed)
    c = _canonical(opts)
    scores = []
    with torch.inference_mode():
        for _ in range(opts.num_items):
            z = torch.as_tensor(rs.randn(1, G.cfg.z_dim), dtype=torch.float32, device=opts.device)
            scores.append(float(eqt_psnr(G, z, c, shift_px)))
    return float(np.mean(scores))


def _rotation(rsz: int, angle: float, device) -> tuple:
    """(grid [1, rsz, rsz, 2], disc [1, rsz, rsz, 1]) of the image-side rotation."""
    ys = (np.arange(rsz) * 2 + 1) / rsz - 1
    xs = (np.arange(rsz) * 2 + 1) / rsz - 1
    gx, gy = np.meshgrid(xs, ys)
    ca, sa = math.cos(angle), math.sin(angle)
    # The image y axis points down; a camera roll by +a turns the content by -a.
    sx = ca * gx - sa * gy
    sy = sa * gx + ca * gy
    grid = torch.as_tensor(np.stack([sx, sy], -1)[None], dtype=torch.float32, device=device)
    disc = torch.as_tensor((gx**2 + gy**2 <= 0.8**2).astype(np.float32)[None, :, :, None],
                           device=device)
    return grid, disc


def eqr_psnr(G, z: torch.Tensor, c: torch.Tensor, angle: float) -> torch.Tensor:
    """The EQ-R PSNR of one latent (a 0-d tensor)."""
    grid, disc = _rotation(G.cfg.render_size, angle, z.device)
    roll = torch.as_tensor(_roll_matrix(angle), device=z.device)
    ws = G.mapping(z, c)
    out0 = G.synthesis(ws, c, return_raw=True)[1]
    c_roll = make_label_25(c[:, :16].reshape(-1, 4, 4) @ roll)
    out1 = G.synthesis(ws, c_roll, return_raw=True)[1]
    ref = F.grid_sample(out0.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False).permute(0, 2, 3, 1)
    return _psnr(ref * disc, out1 * disc)


def compute_eqr(opts: MetricOptions, angle: float = math.pi / 12) -> float:
    """Rotation equivariance: camera roll vs. image rotation (centre disc)."""
    G = opts.G
    rs = np.random.RandomState(opts.seed)
    c = _canonical(opts)
    scores = []
    with torch.inference_mode():
        for _ in range(opts.num_items):
            z = torch.as_tensor(rs.randn(1, G.cfg.z_dim), dtype=torch.float32, device=opts.device)
            scores.append(float(eqr_psnr(G, z, c, angle)))
    return float(np.mean(scores))
