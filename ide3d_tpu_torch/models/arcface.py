"""ArcFace IR-SE50 identity backbone (inference only).

Counterpart of ide3d_tpu/models/arcface.py (the pSp IR-SE50 of the reference's
inversion/criteria/id_loss.py): input 112², bottleneck_IR_SE stages [3, 4, 14,
3] with SE ratio 16, BN running statistics and PReLU, output BN -> flatten ->
linear(512*7*7, 512) -> BN1d. Module and tensor names are those of the torch
`model_ir_se50.pth` state dict (input_layer.N, body.N.res_layer.N,
body.N.shortcut_layer.N, output_layer.N), which are also the JAX tree's keys:
io/from_jax bridges a JAX tree and `metrics.features.load_state_dict_file`
loads the torch file. `embed_faces` is the id loss's crop (rows 35/256..223/256,
columns 32/256..220/256) resized to 112².

`IRSE50` (the input layer and the body) is shared with models/e4e.py. Convs
pad k // 2 on every side, as torch does and as the JAX package pads by hand.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.features import FrozenBN, resize

BN_EPS = 1e-5


def blocks_50() -> List[Tuple[int, int, int]]:
    """(in_channels, depth, stride) of each bottleneck: stages [3, 4, 14, 3],
    the first of each stage at stride 2 (model_irse get_blocks(50))."""
    out = []
    for in_c, depth, n in ((64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)):
        out.append((in_c, depth, 2))
        out.extend((depth, depth, 1) for _ in range(n - 1))
    return out


def conv(ci: int, co: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    """A torch conv padded k // 2, weights left for init() or a file."""
    return nn.utils.skip_init(nn.Conv2d, ci, co, k, stride=stride, padding=k // 2, bias=bias)


def draw_conv(rs: np.random.RandomState, c: nn.Conv2d, std: float = 0.05) -> None:
    """The JAX packages' random init of a conv: N(0, std²) drawn HWIO from `rs`, zero bias."""
    o, i, kh, kw = c.weight.shape
    w = rs.randn(kh, kw, i, o).astype(np.float32) * std
    c.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    if c.bias is not None:
        c.bias.zero_()


def reset_norms(module: nn.Module) -> None:
    """Identity BN (weight 1, bias 0, mean 0, var 1) and PReLU slopes 0.25, as the JAX inits."""
    for m in module.modules():
        if isinstance(m, FrozenBN):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.PReLU):
            m.weight.fill_(0.25)


class SEModule(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = conv(c, c // reduction, 1)
        self.fc2 = conv(c // reduction, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIRSE(nn.Module):
    """BN -> conv3x3 -> PReLU -> conv3x3 (stride) -> BN -> SE, plus the shortcut:
    a 1x1 conv + BN where the width changes, else MaxPool2d(1, stride) (a strided
    slice; no parameters, so body.0 has no shortcut tensors)."""

    def __init__(self, ci: int, depth: int, stride: int):
        super().__init__()
        self.stride = stride
        self.res_layer = nn.Sequential(FrozenBN(ci, BN_EPS), conv(ci, depth, 3), nn.PReLU(depth),
                                       conv(depth, depth, 3, stride), FrozenBN(depth, BN_EPS),
                                       SEModule(depth))
        self.shortcut_layer = None
        if ci != depth:
            self.shortcut_layer = nn.Sequential(conv(ci, depth, 1, stride), FrozenBN(depth, BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.shortcut_layer is not None:
            sc = self.shortcut_layer(x)
        else:
            sc = x[:, :, ::self.stride, ::self.stride]
        return self.res_layer(x) + sc


class IRSE50(nn.Module):
    """input_layer (conv3x3 -> BN -> PReLU) and the 24 bottlenecks; NCHW in and out."""

    def __init__(self):
        super().__init__()
        self.input_layer = nn.Sequential(conv(3, 64, 3), FrozenBN(64, BN_EPS), nn.PReLU(64))
        self.body = nn.Sequential(*(BottleneckIRSE(ci, d, s) for ci, d, s in blocks_50()))

    def draw_body(self, rs: np.random.RandomState) -> None:
        """The bottlenecks' convs in the JAX init's order: res 1, res 3, SE fc1, fc2, shortcut."""
        for blk in self.body:
            for c in (blk.res_layer[1], blk.res_layer[3], blk.res_layer[5].fc1, blk.res_layer[5].fc2):
                draw_conv(rs, c)
            if blk.shortcut_layer is not None:
                draw_conv(rs, blk.shortcut_layer[0])


class ArcFaceIRSE50(IRSE50):
    embed_dim = 512

    def __init__(self):
        super().__init__()
        self.output_layer = nn.Sequential(
            FrozenBN(512, BN_EPS), nn.Identity(), nn.Flatten(),  # BN, Dropout (eval), Flatten
            nn.utils.skip_init(nn.Linear, 512 * 7 * 7, 512), FrozenBN(512, BN_EPS))

    @torch.no_grad()
    def init(self) -> "ArcFaceIRSE50":
        """The JAX package's random init (numpy RandomState(0), in its order):
        convs N(0, 0.05²), the linear N(0, 0.01²) drawn [in, out], identity BN,
        PReLU 0.25; the same weights as `ArcFaceIRSE50().init()` there. Returns self."""
        rs = np.random.RandomState(0)
        draw_conv(rs, self.input_layer[0])
        lin = self.output_layer[3]
        w = rs.randn(lin.in_features, lin.out_features).astype(np.float32) * 0.01
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.zero_()
        self.draw_body(rs)
        reset_norms(self)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 112, 112, 3] in [-1, 1] (NHWC) -> embeddings [B, 512]."""
        x = self.body(self.input_layer(x.permute(0, 3, 1, 2)))
        return self.output_layer(x)  # flattened in (C, H, W) order, as torch and the JAX tree

    def embed_faces(self, images: torch.Tensor) -> torch.Tensor:
        """The id loss's preprocessing: the face box (rows 35/256..223/256,
        columns 32/256..220/256) resized to 112² (jax.image.resize's filter,
        antialiased when shrinking), then embedded."""
        _, H, W, _ = images.shape
        y0, y1 = int(35 / 256 * H), int(223 / 256 * H)
        x0, x1 = int(32 / 256 * W), int(220 / 256 * W)
        return self(resize(images[:, y0:y1, x0:x1, :], 112))
