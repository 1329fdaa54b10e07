"""BiSeNet face parser (inference only), the semantic oracle of inversion.

Counterpart of ide3d_tpu/models/bisenet.py (the reference's inversion/BiSeNet.py
with its torchvision-style ResNet18): the context path (ResNet18 feat8 /
feat16 / feat32, attention refinement, the global-average head and two
align-corners upsamples), the feature fusion module and the output head,
then an align-corners upsample of the logits to the input size. Module and
tensor names follow the `segNet-20Class.pth` state dict (cp.resnet.*,
cp.arm16.*, ffm.*, conv_out.*), which are the JAX tree's keys too; the
checkpoint's auxiliary heads (conv_out16, conv_out32) are not built, as the
JAX package leaves them unused. BN is eval-mode with the running statistics.
Images and logits are NHWC, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.features import FrozenBN
from .arcface import BN_EPS, conv, draw_conv, reset_norms


def resize_bilinear_ac(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True (torch's F.interpolate in
    the context path): a 1-wide input axis broadcasts, a 1-wide output axis
    samples input coordinate 0 (the JAX package's degenerate-axis rules)."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class ConvBNReLU(nn.Module):
    def __init__(self, ci: int, co: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.conv = conv(ci, co, k, stride)
        self.bn = FrozenBN(co, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    """torchvision BasicBlock: conv3x3-bn-relu, conv3x3-bn, (+ 1x1 downsample), relu."""

    def __init__(self, ci: int, co: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = conv(ci, co, 3, stride), FrozenBN(co, BN_EPS)
        self.conv2, self.bn2 = conv(co, co, 3), FrozenBN(co, BN_EPS)
        self.downsample = None
        if stride != 1 or ci != co:
            self.downsample = nn.Sequential(conv(ci, co, 1, stride), FrozenBN(co, BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = conv(3, 64, 7, 2), FrozenBN(64, BN_EPS)
        for i, (ci, co, s) in enumerate(((64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2))):
            setattr(self, f"layer{i + 1}", nn.Sequential(BasicBlock(ci, co, s), BasicBlock(co, co, 1)))

    def forward(self, x: torch.Tensor):
        """-> (feat8 128ch /8, feat16 256ch /16, feat32 512ch /32)."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, padding=1)
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinement(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv = ConvBNReLU(ci, co)
        self.conv_atten = conv(co, co, 1)
        self.bn_atten = FrozenBN(co, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = self.conv_atten(feat.mean(dim=(2, 3), keepdim=True))
        return feat * torch.sigmoid(self.bn_atten(atten))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinement(256, 128)
        self.arm32 = AttentionRefinement(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, 1)

    def forward(self, x: torch.Tensor):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(feat32.mean(dim=(2, 3), keepdim=True))
        feat32_up = resize_bilinear_ac(self.arm32(feat32) + avg, feat16.shape[2:])
        feat32_up = self.conv_head32(feat32_up)
        feat16_up = resize_bilinear_ac(self.arm16(feat16) + feat32_up, feat8.shape[2:])
        return feat8, self.conv_head16(feat16_up), feat32_up


class FeatureFusion(nn.Module):
    def __init__(self, ci: int = 256, co: int = 256):
        super().__init__()
        self.convblk = ConvBNReLU(ci, co, 1)
        self.conv1 = conv(co, co // 4, 1)
        self.conv2 = conv(co // 4, co, 1)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(feat.mean(dim=(2, 3), keepdim=True)))))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, ci: int, mid: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(ci, mid)
        self.conv_out = conv(mid, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """forward(img [B,H,W,3]) -> logits [B,H,W,n_classes] (NHWC)."""

    def __init__(self, n_classes: int = 20):
        super().__init__()
        self.n_classes = n_classes
        self.cp = ContextPath()
        self.ffm = FeatureFusion(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)

    @torch.no_grad()
    def init(self) -> "BiSeNet":
        """The JAX package's random init (numpy RandomState(0), in its order):
        convs N(0, 0.05²) drawn HWIO, identity BN. Returns self."""
        rs = np.random.RandomState(0)
        r = self.cp.resnet
        order = [r.conv1]
        for i in range(1, 5):
            for blk in getattr(r, f"layer{i}"):
                order += [blk.conv1, blk.conv2] + ([blk.downsample[0]] if blk.downsample else [])
        for arm in (self.cp.arm16, self.cp.arm32):
            order += [arm.conv.conv, arm.conv_atten]
        order += [self.cp.conv_head32.conv, self.cp.conv_head16.conv, self.cp.conv_avg.conv,
                  self.ffm.convblk.conv, self.ffm.conv1, self.ffm.conv2,
                  self.conv_out.conv.conv, self.conv_out.conv_out]
        for c in order:
            draw_conv(rs, c)
        reset_norms(self)
        return self

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2)
        feat8, feat_cp8, _ = self.cp(x)
        out = self.conv_out(self.ffm(feat8, feat_cp8))
        return resize_bilinear_ac(out, x.shape[2:]).permute(0, 2, 3, 1)
