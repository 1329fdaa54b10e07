"""Shared CLI plumbing for the port's apps (counterpart of ide3d_tpu/apps/common.py)."""

from __future__ import annotations

import re
from typing import List, Union

import numpy as np
import torch

from ..models.generator import GeneratorConfig, Ide3dGenerator
from ..render.renderer import RenderParams

# Reduced configurations of `random:<seed>:<preset>`, as in the JAX package.
PRESETS = {
    "full": GeneratorConfig(),
    "small": GeneratorConfig(
        img_resolution=64, render_size=16, plane_resolution=64, channel_base=8192,
        channel_max=128, sr_channel_base=4096, sr_channel_max=64, feature_channels=16,
        dtype="float32", render=RenderParams(img_size=16, num_steps=12)),
    "tiny": GeneratorConfig(
        img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
        channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
        dtype="float32", render=RenderParams(img_size=8, num_steps=4)),
}


def parse_range(s: Union[str, List[int]]) -> List[int]:
    """'1,2,5-10' -> [1, 2, 5, ..., 10]."""
    if isinstance(s, list):
        return s
    ranges: List[int] = []
    range_re = re.compile(r"^(\d+)-(\d+)$")
    for p in s.split(","):
        m = range_re.match(p)
        if m:
            ranges.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            ranges.append(int(p))
    return ranges


def save_image_grid(images: np.ndarray, path: str, drange=(-1, 1), grid=None) -> None:
    """images [N, H, W, C] -> one PNG grid."""
    import PIL.Image

    lo, hi = drange
    img = (images - lo) / (hi - lo) * 255.0
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    n, h, w, c = img.shape
    if grid is None:
        gw = int(np.ceil(np.sqrt(n)))
        gh = int(np.ceil(n / gw))
    else:
        gw, gh = grid
    canvas = np.zeros((gh * h, gw * w, c), dtype=np.uint8)
    for i in range(n):
        y, x = divmod(i, gw)
        canvas[y * h: (y + 1) * h, x * w: (x + 1) * w] = img[i]
    if c == 1:
        canvas = canvas[..., 0]
    PIL.Image.fromarray(canvas).save(path)


def load_generator(network: str, device: torch.device | str = "cpu") -> Ide3dGenerator:
    """Build a generator with random weights from a `random:<seed>[:tiny|small]`
    spec. Loading a checkpoint is not ported yet."""
    if not network.startswith("random"):
        raise NotImplementedError("the port loads no checkpoints yet; use random:<seed>[:tiny|small]")
    parts = network.split(":")
    seed = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    preset = parts[2] if len(parts) > 2 else "full"
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; choose from {sorted(PRESETS)}")
    return Ide3dGenerator(PRESETS[preset]).init(seed).to(device).eval()
