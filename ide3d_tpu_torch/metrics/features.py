"""Feature detectors of the metric suite, as torch modules.

Counterpart of ide3d_tpu/metrics/features.py. Every detector takes images
[B, H, W, 3] in [-1, 1] (NHWC, as the JAX package) and returns features
[B, dim]:
  * `PixelFeatures` - the channel mean resized to 32x32; weightless, for
    smoke runs only,
  * `VGG16Features` - the torchvision VGG16 (or VGG19) trunk on (x + 1) * 127.5
    at 224², then the 4096-d fc1 (`classifier.0`); `feature_maps` gives the
    relu taps before each max-pool (the LPIPS taps),
  * `InceptionV3` - the torchvision Inception v3 trunk at 299², BN eps 1e-3,
    avg-pools that count the padding; the 2048-d global average pool.

Parameter names are torchvision's (`features.0.weight`, `classifier.0.weight`,
`Conv2d_1a_3x3.conv.weight`, `Conv2d_1a_3x3.bn.running_mean`, ...), which are
also the JAX trees' keys: io/from_jax.load_jax_params bridges a detector tree
as it is, and a torchvision state_dict file loads by name. BN is the port's
own `FrozenBN` (the four tensors, no `num_batches_tracked`), so a JAX tree
maps one to one. The resizes are `jax.image.resize(..., "linear")`'s filter:
bilinear with half-pixel centres, antialiased when shrinking.
"""

from __future__ import annotations

import os
from typing import Optional, Protocol

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class FeatureExtractor(Protocol):
    dim: int

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] float in [-1, 1] -> features [B, dim]."""


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C]: jax.image.resize(..., "linear"),
    i.e. a triangle filter widened by the scale when shrinking."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


# ------------------------------------------------------------------------ pixel


class PixelFeatures(nn.Module):
    """Weightless stand-in detector: the grayscale image resized to res x res.
    Only for smoke-testing the metric pipeline; NOT comparable with reference
    scores."""

    def __init__(self, res: int = 32):
        super().__init__()
        self.res = res

    @property
    def dim(self) -> int:
        return self.res * self.res

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        gray = images.mean(dim=-1, keepdim=True)
        return resize(gray, self.res).reshape(images.shape[0], -1)


# ------------------------------------------------------------------------ VGG16


_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
              512, 512, 512, 512, "M"]


class VGG16Features(nn.Module):
    """torchvision VGG16 conv trunk + fc1 -> [B, 4096]; cfg_name="vgg19" for the
    VGG19 trunk (the encoder-training perceptual backbone)."""

    def __init__(self, dim: int = 4096, cfg_name: str = "vgg16"):
        super().__init__()
        if cfg_name not in ("vgg16", "vgg19"):
            raise ValueError(f"cfg_name must be 'vgg16' or 'vgg19', got {cfg_name!r}")
        self.dim, self.cfg_name = dim, cfg_name
        self._cfg = _VGG19_CFG if cfg_name == "vgg19" else _VGG16_CFG
        self.features = nn.ModuleDict()
        in_ch, idx = 3, 0
        for v in self._cfg:
            if v == "M":
                idx += 1
                continue
            self.features[str(idx)] = nn.utils.skip_init(nn.Conv2d, in_ch, v, 3, padding=1)
            in_ch, idx = v, idx + 2  # conv + relu
        # Weights come from init() or a file (fc1 alone is 1e8 values: no default init).
        self.classifier = nn.ModuleDict({"0": nn.utils.skip_init(nn.Linear, 512 * 7 * 7, dim)})

    def init(self) -> "VGG16Features":
        """The JAX package's init: numpy RandomState(0), conv weights N(0, 0.05²)
        drawn HWIO, fc1 N(0, 0.01²) drawn [in, out], zero biases; the JAX
        init ignores its key, so this is the seeded detector of every seed."""
        rs = np.random.RandomState(0)
        with torch.no_grad():
            for conv in self.features.values():
                o, i = conv.weight.shape[:2]
                w = rs.randn(3, 3, i, o).astype(np.float32) * 0.05
                conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
                conv.bias.zero_()
            fc = self.classifier["0"]
            w = rs.randn(fc.in_features, fc.out_features).astype(np.float32) * 0.01
            fc.weight.copy_(torch.from_numpy(w.T.copy()))
            fc.bias.zero_()
        return self

    def _taps(self, images: torch.Tensor) -> list:
        """NCHW relu activations before each max-pool, on (images + 1) * 127.5."""
        x = ((images + 1.0) * 127.5).permute(0, 3, 1, 2)
        taps, idx = [], 0
        for v in self._cfg:
            if v == "M":
                taps.append(x)
                x = F.max_pool2d(x, 2, 2)
                idx += 1
                continue
            x = F.relu(self.features[str(idx)](x))
            idx += 2
        return taps

    def feature_maps(self, images: torch.Tensor) -> list:
        """The relu taps before each max-pool, NHWC (views), as the JAX package."""
        return [t.permute(0, 2, 3, 1) for t in self._taps(images)]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self._taps(resize(images, 224))[-1]
        x = F.max_pool2d(x, 2, 2)
        x = resize(x.permute(0, 2, 3, 1), 7).permute(0, 3, 1, 2)
        return self.classifier["0"](x.reshape(x.shape[0], -1))  # NCHW flatten order


# -------------------------------------------------------------------- Inception


class FrozenBN(nn.Module):
    """Inference BatchNorm over dim 1 (NCHW maps or [B, C] vectors) with
    torchvision's four tensor names; eps 1e-3 (Inception) unless given."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * scale.view(shape) + shift.view(shape)


class BasicConv2d(nn.Module):
    """conv (no bias) + BN + relu; padding "SAME" (k // 2, stride 1) or "VALID"."""

    def __init__(self, ci: int, co: int, kh: int, kw: int, stride: int = 1, same: bool = True):
        super().__init__()
        self.conv = nn.utils.skip_init(nn.Conv2d, ci, co, (kh, kw), stride=stride,
                                       padding=(kh // 2, kw // 2) if same else 0, bias=False)
        self.bn = FrozenBN(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max3(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


class _MixedA(nn.Module):
    def __init__(self, ci: int, pool_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(ci, 64, 1, 1)
        self.branch5x5_1 = BasicConv2d(ci, 48, 1, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, 5)
        self.branch3x3dbl_1 = BasicConv2d(ci, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3)
        self.branch_pool = BasicConv2d(ci, pool_ch, 1, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, b3, self.branch_pool(_avg3(x))], dim=1)


class _Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch3x3 = BasicConv2d(288, 384, 3, 3, stride=2, same=False)
        self.branch3x3dbl_1 = BasicConv2d(288, 64, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, 3)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, 3, stride=2, same=False)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3(x)], dim=1)


class _MixedC(nn.Module):
    def __init__(self, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(768, 192, 1, 1)
        self.branch7x7_1 = BasicConv2d(768, c7, 1, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, 1, 7)
        self.branch7x7_3 = BasicConv2d(c7, 192, 7, 1)
        self.branch7x7dbl_1 = BasicConv2d(768, c7, 1, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, 7, 1)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, 1, 7)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, 7, 1)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, 1, 7)
        self.branch_pool = BasicConv2d(768, 192, 1, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for k in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{k}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], dim=1)


class _Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(768, 192, 1, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, 3, stride=2, same=False)
        self.branch7x7x3_1 = BasicConv2d(768, 192, 1, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, 1, 7)
        self.branch7x7x3_3 = BasicConv2d(192, 192, 7, 1)
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, 3, stride=2, same=False)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max3(x)], dim=1)


class _MixedE(nn.Module):
    def __init__(self, ci: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(ci, 320, 1, 1)
        self.branch3x3_1 = BasicConv2d(ci, 384, 1, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, 1, 3)
        self.branch3x3_2b = BasicConv2d(384, 384, 3, 1)
        self.branch3x3dbl_1 = BasicConv2d(ci, 448, 1, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, 3)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, 1, 3)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, 3, 1)
        self.branch_pool = BasicConv2d(ci, 192, 1, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionV3(nn.Module):
    """torchvision Inception v3 feature trunk -> [B, 2048] pooled features (the
    FID detector). [-1, 1] input goes in as it is, resized to 299²."""

    dim = 2048

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, 3, stride=2, same=False)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3, 3, same=False)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, 3)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3, 3, same=False)
        self.Mixed_5b = _MixedA(192, 32)
        self.Mixed_5c = _MixedA(256, 64)
        self.Mixed_5d = _MixedA(288, 64)
        self.Mixed_6a = _Mixed6a()
        self.Mixed_6b = _MixedC(128)
        self.Mixed_6c = _MixedC(160)
        self.Mixed_6d = _MixedC(160)
        self.Mixed_6e = _MixedC(192)
        self.Mixed_7a = _Mixed7a()
        self.Mixed_7b = _MixedE(1280)
        self.Mixed_7c = _MixedE(2048)

    def init(self) -> "InceptionV3":
        """The JAX package's deterministic init: numpy RandomState(0), each conv
        N(0, 0.03²) drawn HWIO in the order the layers are built, identity BN."""
        rs = np.random.RandomState(0)
        with torch.no_grad():
            for m in self.modules():  # registration order = the JAX init's order
                if isinstance(m, BasicConv2d):
                    co, ci, kh, kw = m.conv.weight.shape
                    w = rs.randn(kh, kw, ci, co).astype(np.float32) * 0.03
                    m.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
                elif isinstance(m, FrozenBN):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = resize(images, 299).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max3(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max3(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


# ----------------------------------------------------------------------- factory


def load_state_dict_file(module: nn.Module, path: str, prefixes: Optional[tuple] = None) -> nn.Module:
    """Load a torch state_dict file (torchvision names) into `module`, read with
    weights_only=True. Keys the module does not have (`num_batches_tracked`,
    torchvision's fc / AuxLogits / classifier.3 / classifier.6 heads) are
    skipped, as the JAX package's state_dict_to_tree leaves them unused; a
    tensor the module needs and the file lacks raises. With `prefixes` only the
    module's tensors under them are needed and loaded (e.g. a VGG trunk used for
    its feature maps alone: ("features.",)); the others keep their values."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    own = [k for k in module.state_dict() if prefixes is None or k.startswith(tuple(prefixes))]
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path}: no tensor for {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    module.load_state_dict({k: sd[k] for k in own}, strict=prefixes is None)
    return module


def make_detector(name: str, weights: Optional[str] = None,
                  device: torch.device | str = "cuda") -> nn.Module:
    """The metric detector `name` on `device`, in eval mode, with its weights:
    'pixel' (weightless), 'inception' (InceptionV3, the FID detector), 'vgg16'
    (the PPL detector). `weights` is a torch state_dict file; without it
    inception and vgg16 take the JAX package's deterministic inits
    (relative tracking only: the CLIs warn). The detector carries a
    `provenance` dict that every metric record stamps."""
    if name == "pixel":
        det, source = PixelFeatures(), "weightless-pixel"
    elif name in ("inception", "vgg16"):
        det = InceptionV3() if name == "inception" else VGG16Features()
        if weights:
            load_state_dict_file(det, weights)
            source = "torch-weights"
        else:
            det.init()  # both draw from RandomState(0), as the JAX package's do
            source = "random-init(deterministic)" if name == "inception" else "random-init(seed=0)"
    else:
        raise ValueError(f"unknown detector {name!r} (pixel | inception | vgg16)")
    det.provenance = {"detector": name, "weights": os.path.abspath(weights) if weights else None,
                      "source": source}
    return det.to(device).eval()
