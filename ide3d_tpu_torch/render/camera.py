"""Camera model and ray generation for the pivot-orbit portrait camera.

Counterpart of ide3d_tpu/render/camera.py: screen-space NDC rays (y flipped,
unit length, z = -1/tan(fov/2)), depth bins linspace(ray_start, ray_end), the
look-at cam2world with world up +Y and rotation columns (-left, up, -forward),
and the 25-dim label (flattened 4x4 cam2world ++ flattened 3x3 intrinsics).
Randomness enters through an explicit torch.Generator.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import draw

FOCAL_LENGTH_FFHQ = 4.2647  # normalized focal length
INTRINSICS_FFHQ = np.array(
    [[FOCAL_LENGTH_FFHQ, 0.0, 0.5], [0.0, FOCAL_LENGTH_FFHQ, 0.5], [0.0, 0.0, 1.0]],
    dtype=np.float32,
)
# Canonical front pose at radius 2.7.
CANONICAL_POSE_25 = np.concatenate(
    [
        np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 2.7, 0, 0, 0, 1], dtype=np.float32),
        INTRINSICS_FFHQ.reshape(-1),
    ]
)


def normalize_vecs(v: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def create_cam2world_matrix(forward: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """Look-at cam2world: forward/origin [..., 3] -> [..., 4, 4]."""
    forward = normalize_vecs(forward)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=forward.dtype, device=forward.device).expand_as(forward)
    left = normalize_vecs(torch.linalg.cross(up, forward, dim=-1))
    up = normalize_vecs(torch.linalg.cross(forward, left, dim=-1))

    rot = torch.stack([-left, up, -forward], dim=-1)  # [..., 3, 3] columns
    m = torch.zeros(forward.shape[:-1] + (4, 4), dtype=forward.dtype, device=forward.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = origin
    m[..., 3, 3] = 1.0
    return m


def look_at_pose(
    horizontal_mean: float,
    vertical_mean: float,
    lookat_position: Sequence[float],
    radius: float = 1.0,
    batch_size: int = 1,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """LookAtPoseSampler.sample at the mean pose: cam2world [batch_size, 4, 4].
    The vertical angle is remapped through arccos(1 - 2 v / pi)."""
    h = torch.full((batch_size, 1), float(horizontal_mean), device=device)
    v = torch.full((batch_size, 1), float(vertical_mean), device=device).clamp(1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    theta = h
    origins = torch.cat(
        [
            radius * torch.sin(phi) * torch.cos(theta),
            radius * torch.cos(phi),
            radius * torch.sin(phi) * torch.sin(theta),
        ],
        dim=-1,
    )
    lookat = torch.as_tensor(lookat_position, dtype=torch.float32, device=device)
    return create_cam2world_matrix(normalize_vecs(lookat - origins), origins)


def make_label_25(cam2world: torch.Tensor, intrinsics: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flatten cam2world [B,4,4] (+ intrinsics [B,3,3]) into the 25-dim label."""
    B = cam2world.shape[0]
    if intrinsics is None:
        intrinsics = torch.as_tensor(INTRINSICS_FFHQ, device=cam2world.device).expand(B, 3, 3)
    return torch.cat([cam2world.reshape(B, 16), intrinsics.reshape(B, 9).to(cam2world.dtype)], dim=-1)


def get_initial_rays(
    n: int,
    num_steps: int,
    resolution: Tuple[int, int],
    fov: float,
    ray_start: float,
    ray_end: float,
    offset: Tuple[float, float] = (0.0, 0.0),
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-space rays + depth bins; resolution = (W, H). Returns
      points     [n, W*H, num_steps, 3]  camera-space sample points,
      z_vals     [n, W*H, num_steps, 1]  linspace(ray_start, ray_end),
      rays_d_cam [n, W*H, 3]             unit ray directions.
    Pixels are row-major over (H, W) with y flipped. The batch axis is a
    broadcast view (expand), not a copy."""
    W, H = resolution
    x = torch.linspace(-1.0, 1.0, W, device=device) + offset[0]
    y = torch.linspace(1.0, -1.0, H, device=device) + offset[1]
    yg, xg = torch.meshgrid(y, x, indexing="ij")  # [H, W]: rows scan y, cols scan x
    xf, yf = xg.reshape(-1), yg.reshape(-1)
    zf = -torch.ones_like(xf) / math.tan((2 * math.pi * fov / 360) / 2)
    rays_d_cam = normalize_vecs(torch.stack([xf, yf, zf], dim=-1))  # [WH, 3]

    z_vals = torch.linspace(ray_start, ray_end, num_steps, device=device).reshape(1, num_steps, 1)
    z_vals = z_vals.expand(W * H, num_steps, 1)
    points = rays_d_cam[:, None, :] * z_vals
    return (
        points[None].expand(n, -1, -1, -1),
        z_vals[None].expand(n, -1, -1, -1),
        rays_d_cam[None].expand(n, -1, -1),
    )


def perturb_z_vals(
    generator: torch.Generator, points: torch.Tensor, z_vals: torch.Tensor, ray_directions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stratified jitter of sample depths, uniform within one bin spacing."""
    spacing = z_vals[:, :, 1:2, :] - z_vals[:, :, 0:1, :]
    u = draw(torch.rand, z_vals.shape, generator=generator, device=z_vals.device)
    offset = (u - 0.5) * spacing
    return points + offset * ray_directions[:, :, None, :], z_vals + offset


def transform_rays_to_world(
    points: torch.Tensor,  # [n, R, S, 3] camera-space points
    ray_directions: torch.Tensor,  # [n, R, 3]
    cam2world: torch.Tensor,  # [n, 4, 4]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (world_points [n,R,S,3], world_dirs [n,R,3], world_origins [n,R,3])."""
    n, R = points.shape[:2]
    rot = cam2world[:, :3, :3]
    trans = cam2world[:, :3, 3]
    pts = torch.einsum("nij,nrsj->nrsi", rot, points) + trans[:, None, None, :]
    dirs = torch.einsum("nij,nrj->nri", rot, ray_directions)
    return pts, dirs, trans[:, None, :].expand(n, R, 3)
