"""The IDE-3D generator in PyTorch.

Counterpart of ide3d_tpu/models/generator.py, with the same API shape:

    G.mapping(z, c, truncation_psi, truncation_cutoff) -> ws [B, num_ws, 512]
    G.synthesis(ws, c, render_params=..., noise_mode=..., return_seg=False,
                return_raw=False, return_all=False, table=None)
        -> img | (img, seg) | (img, img_raw) | dict
    G.synthesis.plane_table(ws) -> (the planes as the renderer's table, the
        feature volume or None), which `table=` takes to render another pose
        of the same latent
    G(z, c, cond_img=img) -> the frame of G.encode(img) (use_encoder), at c or,
        when c is None, at the camera of the encoder's yaw/pitch head

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

The optional architectures of the JAX GeneratorConfig:
  * `use_feature_volume`: the hybrid tri-plane/voxel representation. A
    FeatureVolume (models/feature_volume.py) conditioned on ws[:, 0] gives a
    [B, Cf, r, r, r] grid whose trilinear samples are added to the tri-plane
    features before the decoder, on every render;
  * `sr_arch="sg3"`: the alias-free superres stack, 2 * len(block_resolutions)
    SynthesisLayer3s and a ToRGB (models/layers_sg3.py) on the same w rows as
    the SG2 skip blocks, so num_ws does not change;
  * `use_encoder`: the built-in image encoder (models/encoder.Encoder at the
    output size, num_ws rows, fp32) and, with `encoder_predicts_camera`, an FC
    yaw/pitch head; `encode` adds w_avg.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..render.camera import create_cam2world_matrix, make_label_25, normalize_vecs
from ..render.renderer import RenderParams, TriplaneRenderer
from ..utils.profiling import span
from . import plane_graphs
from .blocks import DTYPES, SegSynthesisBlock, SynthesisBlock
from .encoder import Encoder
from .feature_volume import FeatureVolume
from .layers import FullyConnectedLayer, ToRGBLayer, init_seeded
from .layers_sg3 import SynthesisLayer3
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
    # The built-in image encoder (ws and, optionally, a yaw/pitch head from an image).
    use_encoder: bool = False
    encoder_predicts_camera: bool = True
    # The hybrid tri-plane/voxel representation: a FeatureVolume at fv_resolution^3.
    use_feature_volume: bool = False
    fv_resolution: int = 32
    fv_base_channels: int = 128
    # The superres architecture: "sg2" (skip blocks) or "sg3" (alias-free layers).
    sr_arch: str = "sg2"
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
        if cfg.sr_arch not in ("sg2", "sg3"):
            raise ValueError(f"sr_arch must be 'sg2' or 'sg3', got {cfg.sr_arch!r}")
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
        if cfg.sr_arch == "sg2":
            for i, res in enumerate(srr):
                setattr(self, f"b{res}", SynthesisBlock(
                    in_channels=cfg.feature_channels if i == 0 else cfg.sr_channels(srr[i - 1]),
                    out_channels=cfg.sr_channels(res), w_dim=cfg.w_dim, resolution=res,
                    img_channels=cfg.img_channels,
                    up=1 if (i == 0 and res == cfg.render_size) else 2, dtype=cfg.dtype))
        self.feature_volume = None
        if cfg.use_feature_volume:
            self.feature_volume = FeatureVolume(
                feat_res=cfg.fv_resolution, base_channels=cfg.fv_base_channels,
                output_channels=cfg.feature_channels, z_dim=cfg.w_dim)
        self.sg3_sr = self._sg3_layers() if cfg.sr_arch == "sg3" else None

    def _sg3_layers(self) -> nn.Module:
        """The alias-free superres stack (JAX `_sg3_layers`): a refine layer at
        render_size, then an (upsample, refine) pair per octave, padded with
        refines at the output size to 2 * len(block_resolutions) layers, and a
        1x1 ToRGB; cutoff 0.4 and half-width 0.1 of each sampling rate, the
        channels of the nearest superres resolution."""
        cfg = self.cfg
        rs, R, srr = cfg.render_size, cfg.img_resolution, cfg.block_resolutions
        rates = [rs]
        while rates[-1] < R:
            rates.append(rates[-1] * 2)
        pairs = [(rs, rs)]
        for r in rates[:-1]:
            pairs += [(r, r * 2), (r * 2, r * 2)]
        n_convs = 2 * len(srr)
        pairs = (pairs + [(R, R)] * n_convs)[:n_convs]

        def layer(ri, ro, in_ch, out_ch, is_torgb=False):
            return SynthesisLayer3(
                w_dim=cfg.w_dim, is_torgb=is_torgb, in_channels=in_ch, out_channels=out_ch,
                in_size=ri, out_size=ro, in_sampling_rate=float(ri), out_sampling_rate=float(ro),
                in_cutoff=0.4 * ri, out_cutoff=0.4 * ro,
                in_half_width=0.1 * ri, out_half_width=0.1 * ro)

        stack, in_ch = nn.Module(), cfg.feature_channels
        for i, (ri, ro) in enumerate(pairs):
            out_ch = cfg.sr_channels(min(srr, key=lambda b: abs(b - ro)))
            setattr(stack, f"layer{i}", layer(ri, ro, in_ch, out_ch))
            in_ch = out_ch
        stack.num_layers = n_convs
        stack.torgb = layer(R, R, in_ch, cfg.img_channels, is_torgb=True)
        return stack

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
        if self.sg3_sr is not None:
            with span("G.sg3"):
                x = feature.to(self.dtype)
                for i in range(self.sg3_sr.num_layers):
                    x = getattr(self.sg3_sr, f"layer{i}")(x, ws[:, base + i])
                return self.sg3_sr.torgb(x, ws[:, base + self.sg3_sr.num_layers]).float()
        x, img = feature, img_raw
        for i, res in enumerate(self.block_resolutions):
            r0 = base + 2 * i
            ws3 = torch.stack([ws[:, r0], ws[:, r0 + 1], ws[:, min(r0 + 2, self.num_ws - 1)]], dim=1)
            x, img = getattr(self, f"b{res}")(x, img, ws3, noise_mode=noise_mode, generator=generator)
        return img

    def volume(self, ws: torch.Tensor) -> Optional[torch.Tensor]:
        """The hybrid G's feature volume of `ws` (conditioned on row 0) in the
        compute dtype, [B, Cf, r, r, r]; None without use_feature_volume."""
        if self.feature_volume is None:
            return None
        return self.feature_volume(ws[:, 0].float()).to(self.dtype)

    def plane_table(
        self, ws: torch.Tensor, noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(the planes of `ws` in the compute dtype as the renderer's table
        [B, H, W, 3*(Cf+Cs)], the feature volume or None): everything of the
        frame that depends on the latent alone, so a caller may keep it across
        poses (the Painter's plane cache). In inference on the card it is
        replayed from a CUDA graph (`plane_graphs`)."""
        with span("G.planes"):
            return plane_graphs.stage(self, ws, noise_mode, generator)

    def plane_stage(
        self, ws: torch.Tensor, noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """plane_table's operations, eager."""
        img_v, seg_v = self.generate_planes(ws, noise_mode, generator)
        return (self.renderer.build_table(img_v.to(self.dtype), seg_v.to(self.dtype)),
                self.volume(ws))

    def plane_stage_modules(self) -> list:
        """The modules whose parameters and buffers plane_stage reads."""
        mods = [getattr(self, f"vb{res}") for res in self.voxel_block_resolutions]
        return mods if self.feature_volume is None else mods + [self.feature_volume]

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
        table: Optional[tuple] = None,
    ):
        """With a generator, noise_mode='random' draws the layer noise and the
        renderer jitters depths and samples the importance pass at random;
        without one the frame is deterministic. `table` is `plane_table(ws)`
        made earlier; with it neither the planes nor the volume are made
        again (its volume is what the frame samples, None for none)."""
        cfg = self.cfg
        rp = render_params or cfg.render
        if rp.img_size != cfg.render_size:
            raise ValueError(f"render size {rp.img_size} != generator render_size {cfg.render_size}")
        if ws.shape[1] != self.num_ws:
            raise ValueError(f"ws has {ws.shape[1]} rows, generator expects {self.num_ws}")
        noise_gen = generator if noise_mode == "random" else None

        planes, volume = self.plane_table(ws, noise_mode, noise_gen) if table is None else table
        cam2world = c[:, :16].reshape(-1, 4, 4).float()
        with span("G.render"):
            rout = self.renderer.render_fine(self.renderer.render_coarse(
                None, None, cam2world, rp, generator, table=planes, volume=volume), rp)

        with span("G.finish"):
            img, img_raw = self.finish(rout["feature"], ws, noise_mode, noise_gen)
            seg = self._upsample_seg(rout["seg"]) if return_all or return_seg else None

        if return_all:
            return {
                "img": img,
                "img_raw": img_raw,
                "seg": seg,
                "seg_raw": rout["seg"],
                "depth": rout["depth"],
                "weights_sum": rout["weights_sum"],
                "feature": rout["feature"],
            }
        if return_seg:
            return img, seg
        if return_raw:
            return img, img_raw
        return img

    def finish(
        self, feature: torch.Tensor, ws: torch.Tensor, noise_mode: str = "const",
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The frame's 2D epilogue: the rendered feature image [B, r, r, Cf]
        fp32 -> (img [B, R, R, 3], img_raw [B, r, r, 3]), both fp32 NHWC: the
        raw-RGB head (or the first 3 channels) and the superres stack."""
        feature = feature.permute(0, 3, 1, 2)  # [B, Cf, r, r] fp32
        if self.raw_rgb is None:  # raw_head="slice": the first 3 feature channels
            img_raw = feature[:, :3].float()
        else:
            img_raw = self.raw_rgb(feature.to(self.dtype), ws[:, self._raw_row]).float()
        img = self.superresolve(feature, img_raw, ws, noise_mode, generator).permute(0, 2, 3, 1)
        return img, img_raw.permute(0, 2, 3, 1)

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
    """mapping + synthesis (+ the built-in encoder); weights come from
    `init(seed)` or io/from_jax."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.cfg = cfg
        self.synthesis = Ide3dSynthesisNetwork(cfg)
        self.mapping = MappingNetwork(z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim,
                                      num_ws=self.synthesis.num_ws,
                                      num_layers=cfg.mapping_num_layers)
        self.encoder = self.encoder_cam = None
        if cfg.use_encoder:
            self.encoder = Encoder(size=cfg.img_resolution, n_latents=self.num_ws,
                                   w_dim=cfg.w_dim, input_dim=cfg.img_channels)
            if cfg.encoder_predicts_camera:
                self.encoder_cam = FullyConnectedLayer(self.num_ws * cfg.w_dim, 2)

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

    def encode(self, img: torch.Tensor) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """img [B, R, R, 3] in [-1, 1] -> (ws [B, num_ws, w_dim] = encoder + w_avg,
        the yaw/pitch offsets [B, 2] or None) (networks.py:1244-1251)."""
        if self.encoder is None:
            raise ValueError("G has no encoder: GeneratorConfig.use_encoder is False")
        ws = self.encoder(img) + self.mapping.w_avg[None, None, :]
        cam = None if self.encoder_cam is None else self.encoder_cam(ws.reshape(ws.shape[0], -1))
        return ws, cam

    @staticmethod
    def camera_from_yaw_pitch(cam: torch.Tensor) -> torch.Tensor:
        """The encoder head's [B, 2] offsets around pi/2 -> the 25-dim label of
        a camera at radius 2.7 looking at the origin (the JAX G's cond_img path)."""
        radius = 2.7
        yaw = cam[:, 0] + math.pi / 2
        pitch = (cam[:, 1] + math.pi / 2).clamp(1e-5, math.pi - 1e-5)
        origins = torch.stack([radius * torch.sin(pitch) * torch.cos(yaw), radius * torch.cos(pitch),
                               radius * torch.sin(pitch) * torch.sin(yaw)], dim=-1)
        return make_label_25(create_cam2world_matrix(normalize_vecs(-origins), origins))

    def forward(
        self,
        z: Optional[torch.Tensor] = None,
        c: Optional[torch.Tensor] = None,
        truncation_psi: float = 1.0,
        truncation_cutoff: Optional[int] = None,
        cond_img: Optional[torch.Tensor] = None,
        **synthesis_kwargs,
    ):
        """The frame of `cond_img` through the encoder, or of the mapped `z`
        (networks.py:1244-1258). With cond_img and no `c`, the camera comes
        from the encoder's yaw/pitch head."""
        if cond_img is not None:
            ws, cam = self.encode(cond_img)
            if c is None:
                if cam is None:
                    raise ValueError("cond_img without c needs encoder_predicts_camera")
                c = self.camera_from_yaw_pitch(cam)
        else:
            if z is None:
                raise ValueError("G needs z or cond_img")
            ws = self.mapping(z, c, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, c, **synthesis_kwargs)
