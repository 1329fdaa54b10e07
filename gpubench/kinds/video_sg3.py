"""Offline video rendering with the alias-free superres G.

The video kind's traffic, closed loop and counts (kinds/video.py: `setup`,
`unit`, `snapshot`), with two differences: the check renders the kept chunks
again by the plain SG3 reference (reference/sg3.py) and compares them by the
same gap ratios, and the window's work is the SG3 frame's FLOPs
(counts/sg3.py) under `flops`, since counts/flops.py's frame is the SG2
superres G's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..counts import sg3 as counts
from ..reference import generator as ref
from ..reference import sg3
from . import common
from .common import FRONT_POSE
from .video import gap_ratios, interpolate, setup, snapshot, unit  # noqa: F401  (the kind's API)


def finish(st, run, win) -> dict:
    n = win.snapshot["frames"]
    return {"attempted": st.frames, "failed": 0, "e2e": {"frames_per_s": n / win.seconds},
            "work": {"flops": n * counts.frame_flops(run.config), "k1_batch": st.chunk,
                     "sg3_batch": st.chunk}}


def reference_tiles(st, run, P, arch, specs, clip: int, j: int, q=ref.exact) -> np.ndarray:
    """Chunk j of clip `clip` as the SG3 reference renders it from the same latents."""
    dev = torch.device(run.device)
    z = torch.as_tensor(st.zs[clip], device=dev)
    key = ref.with_tf32_off(ref.mapping, P, arch, z,
                            torch.as_tensor(FRONT_POSE, device=dev)[None].expand(z.shape[0], -1))
    ws = interpolate(key.cpu().numpy(), run.traffic["w_frames"])[j * st.chunk:(j + 1) * st.chunk]
    cs = st.cs[j * st.chunk:(j + 1) * st.chunk]
    return ref.with_tf32_off(sg3.frame_u8, P, arch, torch.as_tensor(ws, device=dev),
                             torch.as_tensor(cs, device=dev), q, specs)


def check(st, run, win) -> dict:
    """The compared chunks, drawn from the seed, against the fp32 SG3 reference."""
    rng = np.random.default_rng([run.seed, 2])
    calls = sorted(st.kept)
    picks = rng.choice(len(calls), size=min(run.traffic["compare_calls"], len(calls)), replace=False)
    wanted = [st.kept[calls[p]] for p in sorted(picks)]
    del st.G
    st.kept = None
    common.free(run.device)
    P, arch = common.reference_params(run, st.shapes)
    specs = sg3.layer_specs(arch)
    dtype = run.config["generator"]["dtype"]

    def tiles(q):
        return [reference_tiles(st, run, P, arch, specs, clip, j, q) for clip, j, _ in wanted]

    want, stated = tiles(ref.exact), tiles(ref.STATED[dtype])
    out = gap_ratios([got for _, _, got in wanted], want, stated)
    if run.control:
        lower = gap_ratios(tiles(ref.LOWER[dtype]), want, stated)
        out.update({"control.lower." + k: v for k, v in lower.items()})
    return out
