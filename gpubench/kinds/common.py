"""What the kinds of work share: the pivot-orbit camera's labels, the
program's generator built from a configuration file with seeded weights, its
render parameters, and the reference's copy of the same weights."""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from .. import weights
from ..reference import generator as ref


INTRINSICS = np.array([[4.2647, 0.0, 0.5], [0.0, 4.2647, 0.5], [0.0, 0.0, 1.0]], np.float32)
FRONT_POSE = np.concatenate([np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 2.7, 0, 0, 0, 1],
                                      np.float32), INTRINSICS.reshape(-1)])


def look_at_label(yaw: float, pitch: float, lookat=(0.0, 0.0, 0.2), radius: float = 2.7) -> np.ndarray:
    """The 25-dim label of a camera at (yaw, pitch) offsets from the front,
    looking at `lookat` (the pivot-orbit camera: cam2world ++ intrinsics)."""
    h = math.pi / 2 + yaw
    v = min(max(math.pi / 2 - pitch, 1e-5), math.pi - 1e-5)
    phi = math.acos(1 - 2 * (v / math.pi))
    origin = np.array([radius * math.sin(phi) * math.cos(h), radius * math.cos(phi),
                       radius * math.sin(phi) * math.sin(h)], np.float32)
    fwd = np.asarray(lookat, np.float32) - origin
    fwd = fwd / (np.linalg.norm(fwd) + 1e-9)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    left = np.cross(up, fwd)
    left = left / (np.linalg.norm(left) + 1e-9)
    up = np.cross(fwd, left)
    up = up / (np.linalg.norm(up) + 1e-9)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.stack([-left, up, -fwd], axis=-1)
    m[:3, 3] = origin
    return np.concatenate([m.reshape(-1), INTRINSICS.reshape(-1)]).astype(np.float32)


def generator_config(run):
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    g = dict(run.config["generator"])
    g["render"] = render_params(run)
    for key in ("vb_resolutions_override", "vb_channels_override", "sr_resolutions_override",
                "sr_channels_override"):
        if g.get(key) is not None:
            g[key] = tuple(g[key])
    return GeneratorConfig(**g)


def render_params(run):
    from ide3d_tpu_torch.render.renderer import RenderParams

    rp = dict(run.config["generator"]["render"])
    rp["pixel_offset"] = tuple(rp["pixel_offset"])
    return RenderParams(**rp)


def build_generator(run):
    """(the program's G on the run's device in eval mode with the seed's
    weights, {state name: shape})."""
    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    with torch.device(run.device):
        G = Ide3dGenerator(generator_config(run))
    G = G.to(run.device)
    shapes = {k: tuple(v.shape) for k, v in G.state_dict().items()}
    weights.load_seeded(G, run.config["init"], run.seed)
    return G.eval().requires_grad_(False), shapes


def reference_params(run, shapes: dict) -> tuple:
    """The same seed's weights drawn again for the reference, and its sizes."""
    state = weights.draw_state(shapes, run.config["init"], run.seed, torch.device(run.device))
    return ref.load_params(state, run.device), ref.Arch(run.config["generator"])


def synchronize(device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def free(device: str) -> None:
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
