"""MTCNN face detector (P-Net / R-Net / O-Net): the landmark stage of the
in-the-wild preprocessing.

Counterpart of ide3d_tpu/models/mtcnn.py. The reference's
dataset_preprocessing/ffhq/batch_mtcnn.py:17-70 uses the `mtcnn` package's
detector to write 5 landmarks (left_eye, right_eye, nose, mouth_left,
mouth_right) per image; data/preprocess.align_crop consumes them. The three
cascade CNNs are nn.Modules whose tensor names are facenet-pytorch's
(conv1, prelu1, ..., dense5_1), so `pnet.pt`, `rnet.pt` and `onet.pt` load by
name (`import_mtcnn`). As in facenet-pytorch (a Caffe port), the nets flatten
their feature maps in (W, H, C) order before the dense layers, and the
max-pools keep the last partial window (ceil mode).

The nets take NHWC at their API, as the JAX nets, and run on the device of
their parameters. The cascade (`MTCNN.detect_faces`: the image pyramid, the
proposals, NMS, box regression, the crops) keeps its box arithmetic in
numpy on the host, as the JAX package does; the pyramid levels and the box
crops are resized on the nets' device with `jax.image.resize(...,
"bilinear")`'s filter (a triangle filter widened by the scale when shrinking:
`F.interpolate(bilinear, antialias=True)`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

KEYPOINT_NAMES = ("left_eye", "right_eye", "nose", "mouth_left", "mouth_right")


def _flatten_whc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [N, W*H*C] in (W, H, C) order (the facenet-pytorch flatten)."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class _CascadeNet(nn.Module):
    """Shared init: every conv and dense weight N(0, 1 / fan_in), zero biases,
    PReLU slopes 0.25 (the JAX init's scales), from a seeded CPU generator."""

    @torch.no_grad()
    def init(self, seed: int = 0):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * fan_in ** -0.5)
                m.bias.zero_()
            elif isinstance(m, nn.PReLU):
                m.weight.fill_(0.25)
        return self


def _conv(ci: int, co: int, k: int) -> nn.Conv2d:
    return nn.utils.skip_init(nn.Conv2d, ci, co, k)


def _dense(fin: int, fout: int) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, fin, fout)


class PNet(_CascadeNet):
    """Proposal net, fully convolutional over any input >= 12x12:
    x [N, H, W, 3] -> (probs [N, h, w, 2] softmax, reg [N, h, w, 4])."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = _conv(3, 10, 3), nn.PReLU(10)
        self.conv2, self.prelu2 = _conv(10, 16, 3), nn.PReLU(16)
        self.conv3, self.prelu3 = _conv(16, 32, 3), nn.PReLU(32)
        self.conv4_1, self.conv4_2 = _conv(32, 2, 1), _conv(32, 4, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.prelu1(self.conv1(x.permute(0, 3, 1, 2)))
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(self.prelu2(self.conv2(x))))
        probs = torch.softmax(self.conv4_1(x), dim=1)
        return probs.permute(0, 2, 3, 1), self.conv4_2(x).permute(0, 2, 3, 1)


class RNet(_CascadeNet):
    """Refinement net over 24x24 crops: x [N, 24, 24, 3] -> (probs [N, 2], reg [N, 4])."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = _conv(3, 28, 3), nn.PReLU(28)
        self.conv2, self.prelu2 = _conv(28, 48, 3), nn.PReLU(48)
        self.conv3, self.prelu3 = _conv(48, 64, 2), nn.PReLU(64)
        self.dense4, self.prelu4 = _dense(576, 128), nn.PReLU(128)
        self.dense5_1, self.dense5_2 = _dense(128, 2), _dense(128, 4)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.prelu1(self.conv1(x.permute(0, 3, 1, 2)))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = self.prelu3(self.conv3(x))
        x = self.prelu4(self.dense4(_flatten_whc(x)))
        return torch.softmax(self.dense5_1(x), dim=1), self.dense5_2(x)


class ONet(_CascadeNet):
    """Output net over 48x48 crops: x [N, 48, 48, 3] -> (probs [N, 2], reg
    [N, 4], landmarks [N, 10] = 5 x, then 5 y, normalized to the box)."""

    def __init__(self):
        super().__init__()
        self.conv1, self.prelu1 = _conv(3, 32, 3), nn.PReLU(32)
        self.conv2, self.prelu2 = _conv(32, 64, 3), nn.PReLU(64)
        self.conv3, self.prelu3 = _conv(64, 64, 3), nn.PReLU(64)
        self.conv4, self.prelu4 = _conv(64, 128, 2), nn.PReLU(128)
        self.dense5, self.prelu5 = _dense(1152, 256), nn.PReLU(256)
        self.dense6_1, self.dense6_2, self.dense6_3 = _dense(256, 2), _dense(256, 4), _dense(256, 10)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.prelu1(self.conv1(x.permute(0, 3, 1, 2)))
        x = F.max_pool2d(x, 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu3(self.conv3(x)), 2, 2, ceil_mode=True)
        x = self.prelu4(self.conv4(x))
        x = self.prelu5(self.dense5(_flatten_whc(x)))
        return torch.softmax(self.dense6_1(x), dim=1), self.dense6_2(x), self.dense6_3(x)


def init(seed: int = 0, device: Union[torch.device, str] = "cuda") -> Dict[str, nn.Module]:
    """{'pnet', 'rnet', 'onet'}: the three nets with random weights (seeds
    seed, seed + 1, seed + 2) on `device`, in eval mode."""
    return {name: cls().init(seed + i).to(device).eval()
            for i, (name, cls) in enumerate((("pnet", PNet), ("rnet", RNet), ("onet", ONet)))}


def import_mtcnn(pnet_sd: dict, rnet_sd: dict, onet_sd: dict,
                 device: Union[torch.device, str] = "cuda") -> Dict[str, nn.Module]:
    """facenet-pytorch pnet / rnet / onet state dicts (tensors or arrays) ->
    {'pnet', 'rnet', 'onet'} on `device`, in eval mode. A missing or extra
    tensor raises."""
    nets = {}
    for name, cls, sd in (("pnet", PNet, pnet_sd), ("rnet", RNet, rnet_sd), ("onet", ONet, onet_sd)):
        net = cls()
        net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        nets[name] = net.to(device).eval()
    return nets


# ------------------------------------------------------------- cascade (host)


def nms(boxes: np.ndarray, threshold: float, method: str = "union") -> np.ndarray:
    """Standard MTCNN NMS; boxes [N, 5] = x1, y1, x2, y2, score. Returns kept indices."""
    if boxes.size == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2, s = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3], boxes[:, 4]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(s)
    keep = []
    while order.size > 0:
        i = order[-1]
        keep.append(i)
        rest = order[:-1]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        if method == "min":
            o = inter / np.minimum(area[i], area[rest])
        else:
            o = inter / (area[i] + area[rest] - inter)
        order = rest[o <= threshold]
    return np.asarray(keep, np.int64)


def generate_bounding_boxes(probs: np.ndarray, reg: np.ndarray, scale: float,
                            threshold: float) -> np.ndarray:
    """P-Net feature map -> candidate boxes [N, 9] (x1, y1, x2, y2, score, 4 reg);
    stride 2, cell size 12 (the P-Net receptive-field geometry)."""
    stride, cell = 2, 12
    ys, xs = np.where(probs >= threshold)
    if ys.size == 0:
        return np.zeros((0, 9), np.float32)
    score = probs[ys, xs]
    r = reg[ys, xs]
    q1 = np.stack([np.round((stride * xs + 1) / scale),
                   np.round((stride * ys + 1) / scale)], axis=1)
    q2 = np.stack([np.round((stride * xs + cell) / scale),
                   np.round((stride * ys + cell) / scale)], axis=1)
    return np.concatenate([q1, q2, score[:, None], r], axis=1).astype(np.float32)


def rerec(boxes: np.ndarray) -> np.ndarray:
    """Make boxes square around their center (the cascade's 'rerec')."""
    out = boxes.copy()
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def apply_regression(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    """Calibrate boxes by the regression offsets (relative to box size)."""
    out = boxes.copy()
    w = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
    h = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
    out[:, :4] = boxes[:, :4] + np.concatenate([w, h, w, h], axis=1) * reg
    return out


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, h, w]: jax.image.resize(..., "bilinear")'s filter."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=True)


def _crop_resize(img: torch.Tensor, boxes: np.ndarray, size: int) -> torch.Tensor:
    """Crop each box of img [H, W, 3] (float, on any device; zero-padded at the
    image borders) and resize it to size x size: [N, size, size, 3] on img's
    device. A box wholly outside the image gives zeros."""
    H, W = img.shape[:2]
    chw = img.permute(2, 0, 1)[None]
    out = torch.zeros((len(boxes), 3, size, size), dtype=torch.float32, device=img.device)
    for i, b in enumerate(np.round(boxes[:, :4]).astype(np.int64)):
        x1, y1, x2, y2 = (int(v) for v in b)
        sx1, sy1 = max(x1, 0), max(y1, 0)
        sx2, sy2 = min(x2 + 1, W), min(y2 + 1, H)
        if sx2 <= sx1 or sy2 <= sy1:
            continue
        pad = F.pad(chw[:, :, sy1:sy2, sx1:sx2],
                    (sx1 - x1, x2 + 1 - sx2, sy1 - y1, y2 + 1 - sy2))
        out[i] = _resize(pad, size, size)[0]
    return out.permute(0, 2, 3, 1)


class MTCNN:
    """Cascade detector with the `mtcnn` package's detect_faces contract
    (batch_mtcnn.py:44-70): a list of {'box': [x, y, w, h], 'confidence':
    float, 'keypoints': {name: (x, y)}}. `nets` is {'pnet', 'rnet', 'onet'}
    (`init` or `import_mtcnn`); the cascade runs on their device."""

    def __init__(self, nets: Dict[str, nn.Module], min_face_size: int = 20,
                 scale_factor: float = 0.709,
                 steps_threshold: Tuple[float, float, float] = (0.6, 0.7, 0.7)):
        self.pnet, self.rnet, self.onet = nets["pnet"], nets["rnet"], nets["onet"]
        self.device = next(self.pnet.parameters()).device
        self.min_face_size = min_face_size
        self.scale_factor = scale_factor
        self.steps_threshold = steps_threshold

    @staticmethod
    def _norm(x: torch.Tensor) -> torch.Tensor:
        return (x - 127.5) * 0.0078125

    @torch.no_grad()
    def detect_faces(self, img: np.ndarray) -> List[dict]:
        """img: uint8 or float RGB [H, W, 3] on the host."""
        img = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        H, W = img.shape[:2]
        t1, t2, t3 = self.steps_threshold

        # ---- stage 1: image pyramid + P-Net proposals
        m = 12.0 / self.min_face_size
        min_side = min(H, W) * m
        scales, s = [], m
        while min_side >= 12:
            scales.append(s)
            s *= self.scale_factor
            min_side *= self.scale_factor
        chw = img.permute(2, 0, 1)[None]
        total = []
        for scale in scales:
            hs, ws = int(np.ceil(H * scale)), int(np.ceil(W * scale))
            im = self._norm(_resize(chw, hs, ws)).permute(0, 2, 3, 1)
            probs, reg = self.pnet(im)
            boxes = generate_bounding_boxes(probs[0, :, :, 1].cpu().numpy(), reg[0].cpu().numpy(),
                                            scale, t1)
            if len(boxes):
                total.append(boxes[nms(boxes[:, :5], 0.5)])
        if not total:
            return []
        boxes = np.concatenate(total)
        boxes = boxes[nms(boxes[:, :5], 0.7)]
        boxes = rerec(apply_regression(boxes[:, :5], boxes[:, 5:9]))

        # ---- stage 2: R-Net refinement
        probs, reg = self.rnet(_crop_resize(self._norm(img), boxes, 24))
        probs, reg = probs[:, 1].cpu().numpy(), reg.cpu().numpy()
        keep = probs >= t2
        boxes, reg = boxes[keep], reg[keep]
        boxes[:, 4] = probs[keep]
        if not len(boxes):
            return []
        k = nms(boxes[:, :5], 0.7)
        boxes = rerec(apply_regression(boxes[k], reg[k]))

        # ---- stage 3: O-Net output + landmarks
        probs, reg, lmk = self.onet(_crop_resize(self._norm(img), boxes, 48))
        probs, reg, lmk = probs[:, 1].cpu().numpy(), reg.cpu().numpy(), lmk.cpu().numpy()
        keep = probs >= t3
        boxes, reg, lmk = boxes[keep], reg[keep], lmk[keep]
        boxes[:, 4] = probs[keep]
        if not len(boxes):
            return []
        w = boxes[:, 2] - boxes[:, 0] + 1
        h = boxes[:, 3] - boxes[:, 1] + 1
        pts_x = boxes[:, 0:1] + lmk[:, 0:5] * w[:, None] - 1
        pts_y = boxes[:, 1:2] + lmk[:, 5:10] * h[:, None] - 1
        boxes = apply_regression(boxes, reg)
        k = nms(boxes[:, :5], 0.7, method="min")
        boxes, pts_x, pts_y = boxes[k], pts_x[k], pts_y[k]

        out = []
        for b, px, py in zip(boxes, pts_x, pts_y):
            x1, y1, x2, y2 = b[:4]
            out.append({
                "box": [int(round(x1)), int(round(y1)), int(round(x2 - x1)), int(round(y2 - y1))],
                "confidence": float(b[4]),
                "keypoints": {n: (float(px[i]), float(py[i])) for i, n in enumerate(KEYPOINT_NAMES)},
            })
        return out


def write_detection(result: List[dict], path: str, min_confidence: float = 0.9) -> bool:
    """batch_mtcnn.py:44-70: pick the biggest face, write its 5 landmarks as
    'x y' lines (eye L, eye R, nose, mouth L, mouth R). Returns True if written."""
    if not result:
        return False
    r = result[int(np.argmax([r["box"][2] + r["box"][3] for r in result]))]
    if r["confidence"] <= min_confidence:
        return False
    with open(path, "w") as f:
        for name in KEYPOINT_NAMES:
            x, y = r["keypoints"][name]
            f.write(f"{float(x)} {float(y)}\n")
    return True
