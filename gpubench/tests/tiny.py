"""Tiny sizes of the benchmark's cells for the CPU tests: the port's `tiny`
generator preset, a 32^2 discriminator and encoder, short traffic."""

from __future__ import annotations

import os
import time

import torch

from gpubench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GENERATOR = {
    "img_resolution": 32, "render_size": 8, "plane_resolution": 16, "channel_base": 512,
    "channel_max": 32, "sr_channel_base": 256, "sr_channel_max": 16, "feature_channels": 8,
    "render": {"img_size": 8, "num_steps": 4, "fine_steps": None, "fov": 18.0, "ray_start": 2.25,
               "ray_end": 3.3, "hierarchical": True, "clamp_mode": "softplus", "nerf_noise": 0.0,
               "last_back": False, "white_back": False, "pixel_offset": [0.0, 0.0]},
}
DISCRIMINATOR = {"img_resolution": 32, "channel_base": 512, "channel_max": 32}
ENCODER = {"size": 32, "n_latents_app": 8, "n_latents_geo": 4}
TRAFFIC = {
    "video": {"clips": 2, "num_keyframes": 2, "w_frames": 8, "compare_calls": 2},
    "train": {"pool": 8, "batch": 4, "r1_interval": 2},
    "painter": {"compare": 3},
}


def tiny_run(workload: str, seed: int = 2**31 + 7, seconds: float = 0.3, trace: bool = False,
             dtype: str = "bfloat16", root: str = ROOT) -> harness.Run:
    """The run of `workload` at the tiny sizes on the CPU, computing in `dtype`."""
    torch.set_num_threads(2)
    run = harness.make_run(root, workload, seed, seconds, trace, "cpu", time.perf_counter())
    run.traffic.update(TRAFFIC[run.traffic["kind"]])
    run.config["generator"].update(GENERATOR, dtype=dtype)
    for key, part in (("discriminator", DISCRIMINATOR), ("encoder", ENCODER)):
        if key in run.config:
            run.config[key].update(part, dtype=dtype)
    return run
