"""Deep3DFaceRecon coefficient network (ResNet-50 -> 257 3DMM coefficients).

Counterpart of ide3d_tpu/models/face_recon.py: the `ReconNetWrapper` of
Deep3DFaceRecon_pytorch (models/networks.py, use_last_fc=False), which the
reference's dataset_preprocessing/ffhq/preprocess_in_the_wild.py runs to
regress per-image BFM coefficients; `coeffs_to_pose_label` turns their
angle/trans into the 25-dim camera label (data/preprocess.py).

Architecture: a torchvision-style ResNet-50 trunk (conv1/bn1/maxpool, layer1..4
of bottlenecks with the stride on the 3x3 `conv2`) to a [N, 2048, 1, 1]
feature, then seven 1x1-conv heads concatenated to 257 channels:
    id 80 | exp 64 | tex 80 | angle 3 | gamma 27 | tx,ty 2 | tz 1.
Module and tensor names are those of the torch state dict (`backbone.*`,
`final_layers.{0..6}.*`), so `epoch_20.pth` loads by name; BN is inference
mode (running statistics, eps 1e-5). Written without torchvision. Convs pad
k // 2 on every side, as torch does and as the JAX package pads by hand.

Input contract (test.py): 224x224 RGB in [0, 1], NHWC at the API as in the
JAX package.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..metrics.features import FrozenBN

BN_EPS = 1e-5
# (blocks, channels) per stage of ResNet-50
_STAGES = ((3, 256), (4, 512), (6, 1024), (3, 2048))
_HEAD_DIMS = (80, 64, 80, 3, 27, 2, 1)
COEFF_SLICES = {
    "id": (0, 80), "exp": (80, 144), "tex": (144, 224),
    "angle": (224, 227), "gamma": (227, 254), "trans": (254, 257),
}


def _conv(ci: int, co: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.utils.skip_init(nn.Conv2d, ci, co, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, each with BN; a 1x1 + BN `downsample`
    shortcut on the first block of a stage."""

    def __init__(self, ci: int, co: int, stride: int, downsample: bool):
        super().__init__()
        mid = co // 4
        self.conv1, self.bn1 = _conv(ci, mid, 1), FrozenBN(mid, BN_EPS)
        self.conv2, self.bn2 = _conv(mid, mid, 3, stride), FrozenBN(mid, BN_EPS)
        self.conv3, self.bn3 = _conv(mid, co, 1), FrozenBN(co, BN_EPS)
        self.downsample = (nn.Sequential(_conv(ci, co, 1, stride), FrozenBN(co, BN_EPS))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(out + x)


class ResNet50(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), FrozenBN(64, BN_EPS)
        ci = 64
        for si, (blocks, co) in enumerate(_STAGES):
            # torchvision: stage stride 1 for layer1, else 2, on block 0
            setattr(self, f"layer{si + 1}", nn.Sequential(*(
                Bottleneck(ci if bi == 0 else co, co, 2 if (bi == 0 and si > 0) else 1, bi == 0)
                for bi in range(blocks))))
            ci = co

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for si in range(len(_STAGES)):
            x = getattr(self, f"layer{si + 1}")(x)
        return x.mean(dim=(2, 3), keepdim=True)  # adaptive avg pool to 1x1


class FaceReconNet(nn.Module):
    """ResNet-50 trunk + 7 coefficient heads (ReconNetWrapper's state-dict names)."""

    def __init__(self):
        super().__init__()
        self.backbone = ResNet50()
        self.final_layers = nn.ModuleList(_conv(2048, d, 1, bias=True) for d in _HEAD_DIMS)

    @torch.no_grad()
    def init(self, seed: int = 0) -> "FaceReconNet":
        """Random weights as the JAX init draws them: convs N(0, 1 / fan_in),
        zero head biases, identity BN; from a CPU torch.Generator seeded with
        `seed`, so every device gets the same weights. Returns self."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBN):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, 224, 224, 3] RGB in [0, 1] -> coefficients [N, 257]."""
        feat = self.backbone(x.permute(0, 3, 1, 2))
        return torch.cat([head(feat) for head in self.final_layers], dim=1)[:, :, 0, 0]


def split_coeffs(coeffs: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[N, 257] -> named 3DMM groups (ReconNetWrapper's output layout)."""
    return {k: coeffs[:, a:b] for k, (a, b) in COEFF_SLICES.items()}


def import_face_recon(sd: dict, device: Union[torch.device, str] = "cuda") -> FaceReconNet:
    """A Deep3DFaceRecon epoch_*.pth state dict (tensors or arrays; raw, or
    nested as {'net_recon': sd} or {'state_dict': sd}) -> FaceReconNet on
    `device`, in eval mode. BN counters (`num_batches_tracked`) are not used;
    a tensor the net needs and the dict lacks raises."""
    for key in ("net_recon", "state_dict"):
        if isinstance(sd.get(key), dict):
            sd = sd[key]
    net = FaceReconNet()
    own = net.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"face-recon state dict lacks {missing[:8]}{' ...' if len(missing) > 8 else ''}")
    net.load_state_dict({k: torch.as_tensor(sd[k]) for k in own})
    return net.to(device).eval()


def coeffs_to_pose_label(coeffs: np.ndarray) -> np.ndarray:
    """Image coefficients -> 25-dim dataset label through the pose pipeline
    (3dface2idr_mat.py + preprocess_cameras.py --mode orig, data/preprocess.py).
    coeffs: [257] or [N, 257], on the host."""
    from ..data.preprocess import face_recon_to_pose, fix_intrinsics, fix_pose_orig

    coeffs = np.atleast_2d(np.asarray(coeffs))
    groups = {k: coeffs[:, a:b] for k, (a, b) in COEFF_SLICES.items()}
    labels = []
    for angle, trans in zip(groups["angle"], groups["trans"]):
        pose = fix_pose_orig(face_recon_to_pose(angle, trans))
        K = fix_intrinsics(np.eye(3))
        labels.append(np.concatenate([pose.reshape(-1), K.reshape(-1)]))
    return np.stack(labels).astype(np.float32)
