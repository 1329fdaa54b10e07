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


def write_video(path: str, frames, fps: int = 24) -> str:
    """Write RGB uint8 frames [H, W, 3] to `path`: through imageio when its
    ffmpeg backend is installed, else OpenCV's mp4 writer, else an animated GIF
    beside `path`. Returns the path written."""
    import os

    frames = [np.ascontiguousarray(f) for f in frames]
    try:
        # Without the ffmpeg backend imageio picks a PIL writer that fails on
        # the .mp4 extension when it is collected, so it is not built at all.
        import imageio_ffmpeg  # noqa: F401
        import imageio

        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:
        pass
    try:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("OpenCV has no mp4 writer")
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()
        return path
    except Exception:
        pass
    import PIL.Image

    gif = os.path.splitext(path)[0] + ".gif"
    imgs = [PIL.Image.fromarray(f) for f in frames]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return gif


def load_generator(network: str, device: torch.device | str = "cuda") -> Ide3dGenerator:
    """The generator of `network` on `device` (the CPU only when asked), in eval mode:
      * `random:<seed>[:full|small|tiny]`: random weights from `init(seed)`;
      * a snapshot directory as io/checkpoint.save_checkpoint and train_gan
        write it (state.pt + meta.json): G_ema when the state holds it, else
        the state itself as G's state dict, under the GeneratorConfig of
        meta.json (the flagship's when it has none).
    A reference .pkl loads through ide3d_tpu_torch.io.load_network_pkl."""
    if network.startswith("random"):
        parts = network.split(":")
        seed = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        preset = parts[2] if len(parts) > 2 else "full"
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; choose from {sorted(PRESETS)}")
        return Ide3dGenerator(PRESETS[preset]).init(seed).to(device).eval()

    import os

    from ..io.checkpoint import config_from_jsonable, load_checkpoint

    if not os.path.isdir(network):
        raise FileNotFoundError(
            f"{network!r} is not a snapshot directory (state.pt + meta.json) or random:<seed>; "
            "a reference .pkl loads through ide3d_tpu_torch.io.load_network_pkl")
    state, meta = load_checkpoint(network)
    cfg = config_from_jsonable(meta.get("config") or {})
    if not isinstance(cfg, GeneratorConfig):
        cfg = GeneratorConfig()
    G = Ide3dGenerator(cfg)
    G.load_state_dict(state["G_ema"] if "G_ema" in state else state)
    return G.to(device).eval()
