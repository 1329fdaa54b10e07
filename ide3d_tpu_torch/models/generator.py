"""The IDE-3D generator in PyTorch.

Counterpart of ide3d_tpu/models/generator.py, with the same API shape:

    G.mapping(z, c, truncation_psi, truncation_cutoff) -> ws [B, num_ws, 512]
    G.synthesis(ws, c, render_params=..., noise_mode=..., return_seg=False,
                return_raw=False, return_all=False, table=None)
        -> img | (img, seg) | (img, img_raw) | dict
    G.synthesis.plane_table(ws) -> the planes as the renderer's table, which
        `table=` takes to render another pose of the same latent

c is the 25-dim label (flattened 4x4 cam2world ++ 3x3 intrinsics); images come
back NHWC in fp32, as in the JAX package. The w+ rows are laid out as there:
rows 0..6 the vb modulated convs, row 7 the shared tri-plane ToRGB/ToSEG head,
row 8 the raw-RGB head, rows 9..17 the superres stack.

The reference-compat generator (`vb_ref_compat=True`, the architecture that
io/torch_import hosts reference checkpoints in) has the two-conv vb interior
and the reference's row slicing: each vb block reads num_conv + 1 rows and
advances num_conv, so its shared head row is the first superres conv's row;
with `raw_head="slice"` the raw image is the first 3 feature channels and no
row feeds a raw head. `num_ws` and `synthesis.num_ws_geo` follow from the
configuration; callers take them from the instance.

The frame: `generate_planes` (vb4 -> vb256) gives the texture and semantic
plane stacks; the renderer samples them in the compute dtype (bf16 on the
card) and composites in fp32 (K1 for the merged fine composite); the raw-RGB
head and the superres stack run next, and the 19-class seg is upsampled
bilinearly to the output size.

Not ported yet, and so not in GeneratorConfig: the SG3 superres stack
(`sr_arch`), the feature volume and the built-in encoder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..render.renderer import RenderParams, TriplaneRenderer
from .blocks import DTYPES, SegSynthesisBlock, SynthesisBlock
from .layers import ToRGBLayer, init_seeded
from .mapping import MappingNetwork


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 512
    c_dim: int = 25
    w_dim: int = 512
    img_resolution: int = 512
    img_channels: int = 3
    seg_channels: int = 19
    feature_channels: int = 32
    render_size: int = 64
    plane_resolution: int = 256
    channel_base: int = 32768
    channel_max: int = 512
    sr_channel_base: int = 16384
    sr_channel_max: int = 256
    dtype: str = "bfloat16"  # compute dtype of the conv stacks and plane sampling
    render: RenderParams = RenderParams()
    # Reference-checkpoint compatibility: the two-conv vb interior with the
    # reference's w-row slicing; the raw image from a w-consuming head ("torgb")
    # or as the first 3 feature channels ("slice"); explicit per-block
    # resolutions and channels where a checkpoint's schedule does not follow
    # the channel_base formula (None: the formula).
    vb_ref_compat: bool = False
    raw_head: str = "torgb"
    vb_resolutions_override: Optional[tuple] = None
    vb_channels_override: Optional[tuple] = None
    sr_resolutions_override: Optional[tuple] = None
    sr_channels_override: Optional[tuple] = None
    mapping_num_layers: int = 8

    @property
    def voxel_block_resolutions(self) -> tuple:
        """Tri-plane (vb) stack: 4, 8, ..., plane_resolution."""
        if self.vb_resolutions_override is not None:
            return tuple(self.vb_resolutions_override)
        res, out = [], 4
        while out <= self.plane_resolution:
            res.append(out)
            out *= 2
        return tuple(res)

    @property
    def block_resolutions(self) -> tuple:
        """Superres stack: render_size (refine, no upsample) then x2 up to output."""
        if self.sr_resolutions_override is not None:
            return tuple(self.sr_resolutions_override)
        res, out = [], self.render_size
        while out <= self.img_resolution:
            res.append(out)
            out *= 2
        return tuple(res)

    def vb_channels(self, res: int) -> int:
        if self.vb_channels_override is not None:
            return self.vb_channels_override[self.voxel_block_resolutions.index(res)]
        return min(self.channel_base // res, self.channel_max)

    def sr_channels(self, res: int) -> int:
        if self.sr_channels_override is not None:
            return self.sr_channels_override[self.block_resolutions.index(res)]
        return min(self.sr_channel_base // res, self.sr_channel_max)


class Ide3dSynthesisNetwork(nn.Module):
    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        if cfg.raw_head not in ("torgb", "slice"):
            raise ValueError(f"raw_head must be 'torgb' or 'slice', got {cfg.raw_head!r}")
        self.cfg = cfg
        self.dtype = DTYPES[cfg.dtype]
        vbr, srr = cfg.voxel_block_resolutions, cfg.block_resolutions
        for i, res in enumerate(vbr):
            setattr(self, f"vb{res}", SegSynthesisBlock(
                in_channels=0 if i == 0 else cfg.vb_channels(vbr[i - 1]),
                out_channels=cfg.vb_channels(res), w_dim=cfg.w_dim, resolution=res,
                img_plane_channels=3 * cfg.feature_channels,
                seg_plane_channels=3 * cfg.seg_channels,
                up=1 if i == 0 else 2, dtype=cfg.dtype, ref_compat=cfg.vb_ref_compat))
        self.renderer = TriplaneRenderer(cfg.feature_channels, cfg.seg_channels)
        self.raw_rgb = None
        if cfg.raw_head == "torgb":
            self.raw_rgb = ToRGBLayer(cfg.feature_channels, cfg.img_channels, cfg.w_dim)
        for i, res in enumerate(srr):
            setattr(self, f"b{res}", SynthesisBlock(
                in_channels=cfg.feature_channels if i == 0 else cfg.sr_channels(srr[i - 1]),
                out_channels=cfg.sr_channels(res), w_dim=cfg.w_dim, resolution=res,
                img_channels=cfg.img_channels,
                up=1 if (i == 0 and res == cfg.render_size) else 2, dtype=cfg.dtype))

    @property
    def voxel_block_resolutions(self) -> tuple:
        return self.cfg.voxel_block_resolutions

    @property
    def block_resolutions(self) -> tuple:
        return self.cfg.block_resolutions

    @property
    def _vb_num_conv_total(self) -> int:
        """The vb stack's advance through the w rows (the reference's slicing)."""
        return sum(getattr(self, f"vb{res}").num_conv for res in self.voxel_block_resolutions)

    @property
    def _raw_row(self) -> int:
        """The row of the w-consuming raw-RGB head."""
        if self.cfg.vb_ref_compat:
            return self._vb_num_conv_total
        return len(self.voxel_block_resolutions) + 1

    @property
    def num_ws_geo(self) -> int:
        """Geometry rows of ws: the vb convs and the shared plane head (8 in
        the flagship); the rest are appearance rows (the Painter's appearance lock)."""
        if self.cfg.vb_ref_compat:
            return self._vb_num_conv_total + 1
        return len(self.voxel_block_resolutions) + 1

    @property
    def num_ws(self) -> int:
        if self.cfg.vb_ref_compat:
            # The vb stack advances sum(num_conv); its shared head row is the
            # first superres conv's; 2 rows per superres block + 1 final ToRGB,
            # + 1 for a w-consuming raw head.
            n = self._vb_num_conv_total + 2 * len(self.block_resolutions) + 1
            return n + (1 if self.cfg.raw_head == "torgb" else 0)
        # 7 vb convs + 1 shared plane head + 1 raw-RGB head + 2 per superres block + 1 ToRGB
        return len(self.voxel_block_resolutions) + 2 + 2 * len(self.block_resolutions) + 1

    def generate_planes(
        self, ws: torch.Tensor, noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The vb stack on the geometry rows of ws -> (img_v [B,H,W,3*Cf],
        seg_v [B,H,W,3*Cs]), fp32, channels-last views."""
        x = img_v = seg_v = None
        if self.cfg.vb_ref_compat:
            # The reference's slicing: read num_conv + 1 rows, advance num_conv.
            w_idx = 0
            for res in self.voxel_block_resolutions:
                blk = getattr(self, f"vb{res}")
                x, img_v, seg_v = blk(x, img_v, ws[:, w_idx:w_idx + blk.num_ws_rows],
                                      condition_img=seg_v, noise_mode=noise_mode,
                                      generator=generator)
                w_idx += blk.num_conv
            return img_v.permute(0, 2, 3, 1), seg_v.permute(0, 2, 3, 1)
        n_vb = len(self.voxel_block_resolutions)
        w_planes = ws[:, n_vb]  # the shared head row
        for i, res in enumerate(self.voxel_block_resolutions):
            ws2 = torch.stack([ws[:, i], w_planes], dim=1)
            x, img_v, seg_v = getattr(self, f"vb{res}")(
                x, img_v, ws2, condition_img=seg_v, noise_mode=noise_mode, generator=generator)
        return img_v.permute(0, 2, 3, 1), seg_v.permute(0, 2, 3, 1)

    def superresolve(
        self, feature: torch.Tensor, img_raw: torch.Tensor, ws: torch.Tensor,
        noise_mode: str = "const", generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """feature [B,Cf,r,r], img_raw [B,3,r,r] fp32 -> img [B,3,R,R] fp32."""
        if self.cfg.vb_ref_compat:
            # The first superres row is the vb stack's shared head row, after
            # the raw head's when it has one.
            base = self._vb_num_conv_total + (1 if self.raw_rgb is not None else 0)
        else:
            base = len(self.voxel_block_resolutions) + 2  # first superres row (= 9)
        x, img = feature, img_raw
        for i, res in enumerate(self.block_resolutions):
            r0 = base + 2 * i
            ws3 = torch.stack([ws[:, r0], ws[:, r0 + 1], ws[:, min(r0 + 2, self.num_ws - 1)]], dim=1)
            x, img = getattr(self, f"b{res}")(x, img, ws3, noise_mode=noise_mode, generator=generator)
        return img

    def plane_table(
        self, ws: torch.Tensor, noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """The planes of `ws` in the compute dtype, as the renderer's table
        [B, H, W, 3*(Cf+Cs)]: everything of the frame that depends on the latent
        alone, so a caller may keep it across poses (the Painter's plane cache)."""
        img_v, seg_v = self.generate_planes(ws, noise_mode, generator)
        return self.renderer.build_table(img_v.to(self.dtype), seg_v.to(self.dtype))

    def forward(
        self,
        ws: torch.Tensor,  # [B, num_ws, w_dim]
        c: torch.Tensor,  # [B, 25]
        render_params: Optional[RenderParams] = None,
        noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
        return_seg: bool = False,
        return_raw: bool = False,
        return_all: bool = False,
        table: Optional[torch.Tensor] = None,
    ):
        """With a generator, noise_mode='random' draws the layer noise and the
        renderer jitters depths and samples the importance pass at random;
        without one the frame is deterministic. `table` is `plane_table(ws)`
        made earlier; with it the planes are not generated again."""
        cfg = self.cfg
        rp = render_params or cfg.render
        if rp.img_size != cfg.render_size:
            raise ValueError(f"render size {rp.img_size} != generator render_size {cfg.render_size}")
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws has {ws.shape[1]} rows, generator expects {self.num_ws}")
        noise_gen = generator if noise_mode == "random" else None

        if table is None:
            table = self.plane_table(ws, noise_mode, noise_gen)
        cam2world = c[:, :16].reshape(-1, 4, 4).float()
        rout = self.renderer.render_fine(
            self.renderer.render_coarse(None, None, cam2world, rp, generator, table=table), rp)

        feature = rout["feature"].permute(0, 3, 1, 2)  # [B, Cf, r, r] fp32
        if self.raw_rgb is None:  # raw_head="slice": the first 3 feature channels
            img_raw = feature[:, :3].float()
        else:
            img_raw = self.raw_rgb(feature.to(self.dtype), ws[:, self._raw_row]).float()
        img = self.superresolve(feature, img_raw, ws, noise_mode, noise_gen).permute(0, 2, 3, 1)

        if return_all:
            return {
                "img": img,
                "img_raw": img_raw.permute(0, 2, 3, 1),
                "seg": self._upsample_seg(rout["seg"]),
                "seg_raw": rout["seg"],
                "depth": rout["depth"],
                "weights_sum": rout["weights_sum"],
            }
        if return_seg:
            return img, self._upsample_seg(rout["seg"])
        if return_raw:
            return img, img_raw.permute(0, 2, 3, 1)
        return img

    def _upsample_seg(self, seg_raw: torch.Tensor) -> torch.Tensor:
        """[B,h,w,C] -> [B,R,R,C]; bilinear with half-pixel centres, which is
        what jax.image.resize(..., 'bilinear') computes when upsampling."""
        R = self.cfg.img_resolution
        if seg_raw.shape[1] == R:
            return seg_raw
        up = F.interpolate(seg_raw.permute(0, 3, 1, 2), size=(R, R), mode="bilinear",
                           align_corners=False)
        return up.permute(0, 2, 3, 1)


class Ide3dGenerator(nn.Module):
    """mapping + synthesis; weights come from `init(seed)` or io/from_jax."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.synthesis = Ide3dSynthesisNetwork(cfg)
        self.mapping = MappingNetwork(z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                                      num_ws=self.synthesis.num_ws,
                                      num_layers=cfg.mapping_num_layers)

    @property
    def num_ws(self) -> int:
        return self.synthesis.num_ws

    @property
    def z_dim(self) -> int:
        return self.cfg.z_dim

    @property
    def c_dim(self) -> int:
        return self.cfg.c_dim

    @property
    def w_dim(self) -> int:
        return self.cfg.w_dim

    @property
    def img_resolution(self) -> int:
        return self.cfg.img_resolution

    def init(self, seed: int = 0) -> "Ide3dGenerator":
        """Draw every weight from a CPU torch.Generator seeded with `seed`, so
        the same seed gives the same weights on every device. Returns self."""
        self.mapping.w_avg.zero_()
        return init_seeded(self, seed)

    def forward(
        self,
        z: torch.Tensor,
        c: torch.Tensor,
        truncation_psi: float = 1.0,
        truncation_cutoff: Optional[int] = None,
        **synthesis_kwargs,
    ):
        ws = self.mapping(z, c, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, c, **synthesis_kwargs)
