"""e4e / pSp first-stage inversion encoders (inference path).

Counterpart of ide3d_tpu/models/e4e.py (the reference's vendored
psp_encoders.py): the IR-SE50 FPN backbone of models/arcface.py with
per-style GradualStyleBlock heads - coarse rows from the /16 map (c3),
middle rows from the FPN level p2 (/8), fine rows from p1 (/4):

  * variant "gradual" (GradualStyleEncoder): every row is its own head;
  * variant "e4e" (Encoder4Editing at its inference stage): row 0's head w0
    broadcast, plus each later row's head as a delta.

The two are weight-isomorphic, so a checkpoint's shapes cannot tell them
apart: `load_e4e` reads `opts.encoder_type` from the checkpoint through the
stub unpickler of io/torch_import (no pickled code runs), or takes the
variant from the caller. `pivot_from_image` is the pSp pivot contract:
encoder(x) + latent_avg. Module and tensor names are the checkpoint's
`encoder.*` names without the prefix (input_layer.N, body.N.*, styles.N.convs.2k,
styles.N.linear, latlayer1/2), which are also the JAX tree's keys. Images
are NHWC [B, 256, 256, 3] in [-1, 1].
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .arcface import IRSE50, conv, draw_conv, reset_norms
from .bisenet import resize_bilinear_ac

# IR-SE50 body taps (GradualStyleEncoder.forward: i == 6 / 20 / 23): the ends of
# stage 2 (128 ch, /4), stage 3 (256 ch, /8) and stage 4 (512 ch, /16).
_TAPS = (6, 20, 23)


class EqualLinear(nn.Module):
    """stylegan2 EqualLinear at lr_mul 1: weight [out, in] scaled by 1/sqrt(in) at call time."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * (1.0 / math.sqrt(self.weight.shape[1])), self.bias)


class GradualStyleBlock(nn.Module):
    """num_pools stride-2 3x3 convs (bias, LeakyReLU 0.01) down to 1x1, then
    EqualLinear: [B, 512, h, w] -> [B, 512]."""

    def __init__(self, num_pools: int, c: int = 512):
        super().__init__()
        self.num_pools = num_pools
        self.convs = nn.ModuleDict({str(2 * k): conv(c, c, 3, 2, bias=True) for k in range(num_pools)})
        self.linear = EqualLinear(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_pools):
            x = F.leaky_relu(self.convs[str(2 * k)](x), 0.01)
        return self.linear(x[:, :, 0, 0])


# The pSp heads: rows [0, 3) read the 16² map, [3, 7) the 32², the rest the 64².
COARSE_IND, MIDDLE_IND = 3, 7


class E4eEncoder(IRSE50):
    """GradualStyleEncoder ("gradual") or Encoder4Editing ("e4e") on IR-SE50;
    style_count = 2 log2(stylegan_size) - 2; forward -> [B, style_count, 512]."""

    def __init__(self, stylegan_size: int = 1024, variant: str = "e4e"):
        super().__init__()
        if variant not in ("e4e", "gradual"):
            raise ValueError(f"unknown e4e variant {variant!r} (want 'e4e'|'gradual')")
        self.stylegan_size, self.variant = stylegan_size, variant
        self.style_count = 2 * int(math.log2(stylegan_size)) - 2
        self.styles = nn.ModuleList(
            GradualStyleBlock(int(math.log2(self._head_spatial(i)))) for i in range(self.style_count))
        self.latlayer1 = conv(256, 512, 1, bias=True)
        self.latlayer2 = conv(128, 512, 1, bias=True)

    def _head_spatial(self, i: int) -> int:
        return 16 if i < COARSE_IND else (32 if i < MIDDLE_IND else 64)

    @torch.no_grad()
    def init(self) -> "E4eEncoder":
        """The JAX package's random init (numpy RandomState(0), in its order):
        the input conv, the lateral convs, the body, then per head its linear
        N(0, 1) [in, out] and its convs; convs N(0, 0.05²) drawn HWIO, zero
        biases, identity BN, PReLU 0.25. Returns self."""
        rs = np.random.RandomState(0)
        for c in (self.input_layer[0], self.latlayer1, self.latlayer2):
            draw_conv(rs, c)
        self.draw_body(rs)
        for head in self.styles:
            w = rs.randn(512, 512).astype(np.float32)
            head.linear.weight.copy_(torch.from_numpy(w.T.copy()))
            head.linear.bias.zero_()
            for c in head.convs.values():
                draw_conv(rs, c)
        reset_norms(self)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] in [-1, 1] (256² for a pSp checkpoint) -> codes [B, style_count, 512]."""
        x = self.input_layer(x.permute(0, 3, 1, 2))
        taps = {}
        for i, blk in enumerate(self.body):
            x = blk(x)
            if i in _TAPS:
                taps[i] = x
        c1, c2, c3 = taps[6], taps[20], taps[23]
        p2 = resize_bilinear_ac(c3, c2.shape[2:]) + self.latlayer1(c2)
        p1 = resize_bilinear_ac(p2, c1.shape[2:]) + self.latlayer2(c1)

        def feat(i):
            return c3 if i < COARSE_IND else (p2 if i < MIDDLE_IND else p1)

        if self.variant == "gradual":
            return torch.stack([self.styles[i](feat(i)) for i in range(self.style_count)], dim=1)
        w0 = self.styles[0](c3)
        rows = [w0] + [w0 + self.styles[i](feat(i)) for i in range(1, self.style_count)]
        return torch.stack(rows, dim=1)


@dataclasses.dataclass
class E4eImportReport:
    variant: str
    stylegan_size: int
    style_count: int
    has_latent_avg: bool
    num_params: int


# opts.encoder_type of the pSp / e4e training namespaces
_ENCODER_TYPE_TO_VARIANT = {"Encoder4Editing": "e4e", "GradualStyleEncoder": "gradual"}


def import_e4e(sd: Dict[str, np.ndarray], variant: str = "e4e"
               ) -> Tuple[E4eEncoder, Optional[torch.Tensor], E4eImportReport]:
    """A pSp/e4e state dict (torch layout; 'encoder.*' + 'latent_avg', or a bare
    encoder state dict) -> (E4eEncoder with its weights, latent_avg or None, report).
    stylegan_size comes from the number of style heads; the variant is given."""
    latent_avg = None
    if "latent_avg" in sd:
        latent_avg = torch.as_tensor(np.asarray(sd["latent_avg"], np.float32))
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    if not enc:
        enc = {k: v for k, v in sd.items()
               if k.split(".")[0] in ("input_layer", "body", "styles", "latlayer1", "latlayer2")}
    n_styles = 1 + max(int(k.split(".")[1]) for k in enc if k.startswith("styles."))
    model = E4eEncoder(stylegan_size=int(2 ** ((n_styles + 2) / 2)), variant=variant)
    own = model.state_dict()
    missing = sorted(set(own) - set(enc))
    if missing:
        raise KeyError(f"e4e checkpoint lacks {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    model.load_state_dict({k: torch.as_tensor(np.asarray(enc[k])) for k in own})
    report = E4eImportReport(variant, model.stylegan_size, n_styles, latent_avg is not None,
                             sum(v.numel() for v in own.values()))
    return model, latent_avg, report


def load_e4e(path: str, variant: str = "auto"):
    """An e4e/pSp .pt file -> (model, latent_avg, report). The file is read by
    io/torch_import.load_torch_file_stubbed, so no code from the pickle runs;
    `latent_avg` sits beside `state_dict` at the top level. variant="auto" takes
    it from opts.encoder_type (an argparse Namespace or a dict there) and warns
    and assumes "e4e" without one: the two variants are weight-isomorphic, so a
    wrong guess gives wrong pivots silently."""
    from ..io.torch_import import load_torch_file_stubbed

    obj = load_torch_file_stubbed(path)
    flat = {}
    if isinstance(obj, dict) and "latent_avg" in obj:
        flat["latent_avg"] = obj["latent_avg"].detach().cpu().numpy()
    inner = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    for k, v in inner.items():
        if isinstance(v, torch.Tensor):
            flat[k] = v.detach().cpu().numpy()
    if variant == "auto":
        opts = obj.get("opts") if isinstance(obj, dict) else None
        enc_type = str(opts.get("encoder_type", "")) if isinstance(opts, dict) else ""
        variant = _ENCODER_TYPE_TO_VARIANT.get(enc_type, "")
        if not variant:
            warnings.warn(
                f"{path}: checkpoint carries no recognizable opts.encoder_type (pSp "
                "GradualStyleEncoder and Encoder4Editing are weight-isomorphic); assuming "
                "variant='e4e'. Pass variant= to force.")
            variant = "e4e"
    return import_e4e(flat, variant=variant)


def pivot_from_image(model: E4eEncoder, latent_avg: Optional[torch.Tensor],
                     image: torch.Tensor) -> torch.Tensor:
    """encoder(image) + latent_avg broadcast over the rows (psp.py with
    start_from_latent_avg): image [B,256,256,3] -> w+ [B, style_count, 512]."""
    codes = model(image)
    if latent_avg is not None:
        avg = latent_avg.to(codes.device, codes.dtype)
        codes = codes + (avg[None, None] if avg.ndim == 1 else avg[None] if avg.ndim == 2 else avg)
    return codes
