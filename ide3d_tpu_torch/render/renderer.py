"""Tri-plane volume renderer: the `G.synthesis.renderer` of the port.

Counterpart of ide3d_tpu/render/renderer.py, with the same contract:
  * `sample_voxel(img_v, seg_v, coords [B,N,3]) -> [B,N,52]` =
    32 feature channels ++ 19 semantic channels ++ 1 density (sigma LAST),
  * a stratified coarse pass, a hierarchical importance pass through
    `sample_pdf`, and alpha compositing of features and semantics with the
    same weights over the merged, unsorted coarse + fine samples,
  * ray segment [2.25, 3.3], fov 18 deg, render size 64, 96 + 96 samples.

The merged composite is K1 (ops/ray_march.sort_integrate) for every option
(clamp mode, density noise, last_back, white_back): the CUDA kernel and its
hand-written backward on the card, its plain version on the CPU. The
importance depths are detached, as the JAX render stop-gradients them. Planes keep the JAX layout
[B, H, W, 3*C]; randomness enters through an explicit torch.Generator.

The hybrid generator's feature volume ([B, C, D, H, W], `volume=`) is sampled
trilinearly at the same points, and its features are added to the tri-plane
features before the decoder, in the table's dtype; the fine pass takes it
from the coarse state. `RenderParams.fine_steps` sets the importance pass's
depth count (None: num_steps), so K1 composites halves of S and F samples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..ops.bias_act import bias_act
from ..ops.grid_sample import grid_sample_3d, sample_from_triplane
from ..ops.ray_march import sort_integrate
from ..parallel.mesh import draw
from .camera import get_initial_rays, perturb_z_vals, transform_rays_to_world
from .integration import integrate_rays, sample_pdf


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static rendering configuration; the pose comes from cam2world."""

    img_size: int = 64
    num_steps: int = 96  # coarse steps
    # importance samples of the hierarchical pass; None = num_steps (the
    # reference's 1:1 split), e.g. 64 + 128 spends the same 192 samples a ray
    fine_steps: Optional[int] = None
    fov: float = 18.0
    ray_start: float = 2.25
    ray_end: float = 3.3
    hierarchical: bool = True
    clamp_mode: str = "softplus"
    nerf_noise: float = 0.0
    last_back: bool = False
    white_back: bool = False
    # principal-point shift in NDC units (the equivariance metrics)
    pixel_offset: tuple = (0.0, 0.0)


class TriplaneRenderer(nn.Module):
    decoder_hidden = 64

    def __init__(self, feature_channels: int = 32, seg_channels: int = 19):
        super().__init__()
        self.feature_channels = feature_channels
        self.seg_channels = seg_channels
        c, h = feature_channels, self.decoder_hidden
        # Unit-variance weights [in, out]; the equalized-lr gains apply at call time.
        self.dec_w1 = nn.Parameter(torch.empty(c, h))
        self.dec_b1 = nn.Parameter(torch.zeros(h))
        self.dec_w2 = nn.Parameter(torch.empty(h, c + 1))
        self.dec_b2 = nn.Parameter(torch.zeros(c + 1))

    @property
    def out_channels(self) -> int:
        return self.feature_channels + self.seg_channels + 1  # 52

    def init_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.dec_w1.normal_(generator=generator)
            self.dec_w2.normal_(generator=generator)
            self.dec_b1.zero_()
            self.dec_b2.zero_()

    # ------------------------------------------------------------------ sampling

    def decode_features(self, feat: torch.Tensor) -> torch.Tensor:
        """[..., 32] tri-plane features -> [..., 33] (32 features ++ sigma)."""
        c, h = self.feature_channels, self.decoder_hidden
        dt = feat.dtype
        w1 = self.dec_w1.to(dt) * (1.0 / math.sqrt(c))
        w2 = self.dec_w2.to(dt) * (1.0 / math.sqrt(h))
        x = bias_act(feat @ w1, self.dec_b1.to(dt), dim=-1, act="lrelu")
        return x @ w2 + self.dec_b2.to(dt)

    def build_table(self, img_v: torch.Tensor, seg_v: torch.Tensor) -> torch.Tensor:
        """The texture and semantic planes side by side, plane by plane:
        [B,H,W,3*Cf], [B,H,W,3*Cs] -> [B, H, W, 3*(Cf+Cs)], built once per plane
        set and shared by both passes."""
        B, H, W, _ = img_v.shape
        fc, sc = self.feature_channels, self.seg_channels
        table = torch.cat([img_v.reshape(B, H, W, 3, fc), seg_v.reshape(B, H, W, 3, sc)], dim=-1)
        return table.reshape(B, H, W, 3 * (fc + sc))

    def sample_table(self, table: torch.Tensor, coords: torch.Tensor,
                     volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample_voxel from a table made once (build_table), in its dtype;
        the volume's features, when given, are added before decoding."""
        fc = self.feature_channels
        sampled = sample_from_triplane(coords, table)
        feat, seg = sampled[..., :fc], sampled[..., fc:]
        if volume is not None:
            feat = feat + grid_sample_3d(volume, coords).to(feat.dtype)
        decoded = self.decode_features(feat)
        return torch.cat([decoded[..., :fc], seg, decoded[..., -1:]], dim=-1)

    def sample_voxel(self, img_v: torch.Tensor, seg_v: torch.Tensor, coords: torch.Tensor,
                     volume: Optional[torch.Tensor] = None) -> torch.Tensor:
        """coords [B,N,3] world -> [B,N,52], layout [feat(32) | seg(19) | sigma(1)];
        `volume` is the hybrid generator's feature volume [B,C,D,H,W]."""
        return self.sample_table(self.build_table(img_v, seg_v), coords, volume)

    # ----------------------------------------------------------------- rendering

    def render_coarse(
        self,
        img_v: Optional[torch.Tensor],  # [B, res, res, 3*32]; None when table is given
        seg_v: Optional[torch.Tensor],  # [B, res, res, 3*19]
        cam2world: torch.Tensor,  # [B, 4, 4]
        rp: RenderParams,
        generator: Optional[torch.Generator] = None,
        table: Optional[torch.Tensor] = None,  # build_table(img_v, seg_v), made earlier
        volume: Optional[torch.Tensor] = None,  # the hybrid G's feature volume [B,C,D,H,W]
        ray_slice: Optional[tuple] = None,  # (start, length): a contiguous block of rays
    ) -> dict:
        """Coarse pass (+ importance depths when hierarchical). Returns the state
        `render_fine` consumes. With no generator the pass is deterministic:
        no depth jitter and sample_pdf on linspace CDF positions. A caller that
        keeps the planes across poses passes their `table`.

        `ray_slice=(start, length)` renders only the rays [start, start +
        length) of the row-major pixel grid (parallel/render.py's ray-sharded
        frame); per-ray work is independent, so the block's outputs are those
        rows of the whole pass. Pair it with `render_fine(..., flat=True)`."""
        B = cam2world.shape[0]
        S = rp.num_steps
        W = H = rp.img_size
        Rr = W * H
        dev = cam2world.device

        points_cam, z_vals, rays_d_cam = get_initial_rays(
            B, S, (W, H), rp.fov, rp.ray_start, rp.ray_end, offset=rp.pixel_offset, device=dev)
        if generator is not None:
            points_cam, z_vals = perturb_z_vals(generator, points_cam, z_vals, rays_d_cam)
        pts, dirs, origins = transform_rays_to_world(points_cam, rays_d_cam, cam2world)
        if ray_slice is not None:
            start, Rr = ray_slice
            pts, dirs, origins, z_vals, rays_d_cam = (
                t[:, start:start + Rr] for t in (pts, dirs, origins, z_vals, rays_d_cam))

        if table is None:
            table = self.build_table(img_v, seg_v)
        coarse = self.sample_table(table, pts.reshape(B, Rr * S, 3), volume)
        coarse = coarse.reshape(B, Rr, S, self.out_channels)
        st = {"table": table, "volume": volume, "coarse": coarse, "z_vals": z_vals,
              "rays_d_cam": rays_d_cam, "dirs": dirs, "origins": origins, "generator": generator}
        if rp.hierarchical:
            _, _, weights = integrate_rays(coarse, rays_d_cam, z_vals, generator=generator,
                                           noise_std=rp.nerf_noise, clamp_mode=rp.clamp_mode,
                                           weights_only=True)
            w_flat = weights.reshape(B * Rr, S)[:, 1:-1]
            z_flat = z_vals.reshape(B * Rr, S)
            z_mid = 0.5 * (z_flat[:, :-1] + z_flat[:, 1:])
            F_ = rp.fine_steps if rp.fine_steps is not None else S
            fine_z = sample_pdf(z_mid, w_flat, F_, generator=generator, det=generator is None)
            # Constants of the fine pass, as the JAX render stop-gradients them:
            # no gradient flows through the importance depths to the coarse weights.
            st["fine_z"] = fine_z.reshape(B, Rr, F_, 1).detach()
        return st

    def render_fine(self, st: dict, rp: RenderParams, flat: bool = False) -> dict:
        """Fine pass + compositing of the merged samples. Returns dict(feature
        [B,H,W,32], seg [B,H,W,19], depth [B,H,W,1], weights_sum [B,H,W,1]);
        `flat=True` keeps the ray axis ([B, R, C]), as a `ray_slice` pass needs."""
        coarse, z_vals, rays_d_cam = st["coarse"], st["z_vals"], st["rays_d_cam"]
        B, Rr, S, _ = coarse.shape
        W = H = rp.img_size
        gen = st["generator"]

        if rp.hierarchical:
            fine_z = st["fine_z"]
            F_ = fine_z.shape[2]
            fine_pts = st["origins"][:, :, None, :] + st["dirs"][:, :, None, :] * fine_z
            fine = self.sample_table(st["table"], fine_pts.reshape(B, Rr * F_, 3), st["volume"])
            fine = fine.reshape(B, Rr, F_, self.out_channels)
            noise = None
            if gen is not None and rp.nerf_noise > 0:
                # The draw of integrate_rays_merged: [B, R, S+F], input order.
                noise = draw(torch.randn, (B, Rr, S + F_), generator=gen,
                             device=coarse.device) * rp.nerf_noise
            ray_norm = torch.linalg.vector_norm(rays_d_cam.float(), dim=-1, keepdim=True)
            comp, depth, wsum = sort_integrate(
                z_vals.float().contiguous(), coarse.contiguous(),
                fine_z.float().contiguous(), fine.contiguous(), ray_norm.contiguous(),
                noise=noise, clamp_mode=rp.clamp_mode, last_back=rp.last_back,
                white_back=rp.white_back)
        else:
            comp, depth, weights = integrate_rays(
                coarse, rays_d_cam, z_vals, generator=gen, noise_std=rp.nerf_noise,
                clamp_mode=rp.clamp_mode, last_back=rp.last_back, white_back=rp.white_back)
            wsum = weights.sum(dim=-2)

        fc = self.feature_channels
        grid = (B, Rr) if flat else (B, H, W)
        return {
            "feature": comp[..., :fc].reshape(*grid, fc),
            "seg": comp[..., fc:].reshape(*grid, self.seg_channels),
            "depth": depth.reshape(*grid, 1),
            "weights_sum": wsum.reshape(*grid, 1),
        }

    def render(
        self,
        img_v: torch.Tensor,
        seg_v: torch.Tensor,
        cam2world: torch.Tensor,
        rp: RenderParams,
        generator: Optional[torch.Generator] = None,
        volume: Optional[torch.Tensor] = None,
    ) -> dict:
        """Volume-render feature image + semantics + depth at rp.img_size."""
        return self.render_fine(
            self.render_coarse(img_v, seg_v, cam2world, rp, generator, volume=volume), rp)
