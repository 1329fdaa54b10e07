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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..ops.bias_act import bias_act
from ..ops.grid_sample import sample_from_triplane
from ..ops.ray_march import sort_integrate
from .camera import get_initial_rays, perturb_z_vals, transform_rays_to_world
from .integration import integrate_rays, sample_pdf


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static rendering configuration; the pose comes from cam2world."""

    img_size: int = 64
    num_steps: int = 96  # coarse steps, and as many importance samples
    fov: float = 18.0
    ray_start: float = 2.25
    ray_end: float = 3.3
    hierarchical: bool = True
    clamp_mode: str = "softplus"
    nerf_noise: float = 0.0
    last_back: bool = False
    white_back: bool = False


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

    def sample_table(self, table: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """sample_voxel from a table made once (build_table), in its dtype."""
        fc = self.feature_channels
        sampled = sample_from_triplane(coords, table)
        feat, seg = sampled[..., :fc], sampled[..., fc:]
        decoded = self.decode_features(feat)
        return torch.cat([decoded[..., :fc], seg, decoded[..., -1:]], dim=-1)

    def sample_voxel(self, img_v: torch.Tensor, seg_v: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """coords [B,N,3] world -> [B,N,52], layout [feat(32) | seg(19) | sigma(1)]."""
        return self.sample_table(self.build_table(img_v, seg_v), coords)

    # ----------------------------------------------------------------- rendering

    def render_coarse(
        self,
        img_v: Optional[torch.Tensor],  # [B, res, res, 3*32]; None when table is given
        seg_v: Optional[torch.Tensor],  # [B, res, res, 3*19]
        cam2world: torch.Tensor,  # [B, 4, 4]
        rp: RenderParams,
        generator: Optional[torch.Generator] = None,
        table: Optional[torch.Tensor] = None,  # build_table(img_v, seg_v), made earlier
    ) -> dict:
        """Coarse pass (+ importance depths when hierarchical). Returns the state
        `render_fine` consumes. With no generator the pass is deterministic:
        no depth jitter and sample_pdf on linspace CDF positions. A caller that
        keeps the planes across poses passes their `table`."""
        B = cam2world.shape[0]
        S = rp.num_steps
        W = H = rp.img_size
        Rr = W * H
        dev = cam2world.device

        points_cam, z_vals, rays_d_cam = get_initial_rays(
            B, S, (W, H), rp.fov, rp.ray_start, rp.ray_end, device=dev)
        if generator is not None:
            points_cam, z_vals = perturb_z_vals(generator, points_cam, z_vals, rays_d_cam)
        pts, dirs, origins = transform_rays_to_world(points_cam, rays_d_cam, cam2world)

        if table is None:
            table = self.build_table(img_v, seg_v)
        coarse = self.sample_table(table, pts.reshape(B, Rr * S, 3)).reshape(B, Rr, S, self.out_channels)
        st = {"table": table, "coarse": coarse, "z_vals": z_vals, "rays_d_cam": rays_d_cam,
              "dirs": dirs, "origins": origins, "generator": generator}
        if rp.hierarchical:
            _, _, weights = integrate_rays(coarse, rays_d_cam, z_vals, generator=generator,
                                           noise_std=rp.nerf_noise, clamp_mode=rp.clamp_mode,
                                           weights_only=True)
            w_flat = weights.reshape(B * Rr, S)[:, 1:-1]
            z_flat = z_vals.reshape(B * Rr, S)
            z_mid = 0.5 * (z_flat[:, :-1] + z_flat[:, 1:])
            fine_z = sample_pdf(z_mid, w_flat, S, generator=generator, det=generator is None)
            # Constants of the fine pass, as the JAX render stop-gradients them:
            # no gradient flows through the importance depths to the coarse weights.
            st["fine_z"] = fine_z.reshape(B, Rr, S, 1).detach()
        return st

    def render_fine(self, st: dict, rp: RenderParams) -> dict:
        """Fine pass + compositing of the merged samples. Returns dict(feature
        [B,H,W,32], seg [B,H,W,19], depth [B,H,W,1], weights_sum [B,H,W,1])."""
        coarse, z_vals, rays_d_cam = st["coarse"], st["z_vals"], st["rays_d_cam"]
        B, Rr, S, _ = coarse.shape
        W = H = rp.img_size
        gen = st["generator"]

        if rp.hierarchical:
            fine_z = st["fine_z"]
            F_ = fine_z.shape[2]
            fine_pts = st["origins"][:, :, None, :] + st["dirs"][:, :, None, :] * fine_z
            fine = self.sample_table(st["table"], fine_pts.reshape(B, Rr * F_, 3))
            fine = fine.reshape(B, Rr, F_, self.out_channels)
            noise = None
            if gen is not None and rp.nerf_noise > 0:
                # The draw of integrate_rays_merged: [B, R, S+F], input order.
                noise = torch.randn((B, Rr, S + F_), generator=gen,
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
        return {
            "feature": comp[..., :fc].reshape(B, H, W, fc),
            "seg": comp[..., fc:].reshape(B, H, W, self.seg_channels),
            "depth": depth.reshape(B, H, W, 1),
            "weights_sum": wsum.reshape(B, H, W, 1),
        }

    def render(
        self,
        img_v: torch.Tensor,
        seg_v: torch.Tensor,
        cam2world: torch.Tensor,
        rp: RenderParams,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """Volume-render feature image + semantics + depth at rp.img_size."""
        return self.render_fine(self.render_coarse(img_v, seg_v, cam2world, rp, generator), rp)
