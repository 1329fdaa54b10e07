"""Offline video rendering: `gen_videos.render_chunks` in a closed loop.

The traffic file's parameters: `clips` clips of `num_keyframes` latents each
(drawn from the seed), `w_frames` frames a keyframe transition, rendered
`chunk` frames at a time in `image_mode`; each window unit renders one whole
clip, the clips in turn. The latents go through the program's mapping at the
front pose, then a periodic cubic interpolation (gen_videos' own), while the
camera orbits (gen_videos' `orbit_label`). Both are copied here, so that the
traffic stays what it is whatever the program does.

For the check, one chunk of every unit is kept as it reached the host; once
the window has closed, `compare_calls` of those, drawn from the seed, are
rendered again by the plain reference from the same latents.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from ..reference import generator as ref
from . import common
from .common import FRONT_POSE, look_at_label

def orbit_label(fi: int, total: int) -> np.ndarray:
    """Frame `fi` of `total`: yaw 0.4 sin, pitch 0.05 cos of the orbit phase."""
    return look_at_label(0.4 * math.sin(2 * math.pi * fi / total),
                         0.05 * math.cos(2 * math.pi * fi / total))


def interpolate(key_ws: np.ndarray, w_frames: int) -> np.ndarray:
    """Keyframe ws [K, num_ws, w_dim] -> [K * w_frames, num_ws, w_dim]: the
    periodic cubic spline through the keyframes, sampled w_frames a transition."""
    from scipy import interpolate as sinterp

    K = key_ws.shape[0]
    spline = sinterp.interp1d(np.arange(-K * 2, K * 2), np.tile(key_ws, [4, 1, 1]),
                              kind="cubic", axis=0)
    return np.stack([spline(fi / w_frames) for fi in range(K * w_frames)]).astype(np.float32)


def setup(run):
    from ide3d_tpu_torch.apps import gen_videos

    tr, dev = run.traffic, torch.device(run.device)
    G, shapes = common.build_generator(run)
    K, wf, chunk = tr["num_keyframes"], tr["w_frames"], tr["chunk"]
    total = K * wf
    if total % chunk:
        raise ValueError("a clip's frames must divide into whole chunks")
    rng = np.random.default_rng(run.seed)
    zs = rng.standard_normal((tr["clips"], K, G.z_dim)).astype(np.float32)
    with torch.inference_mode():
        key_ws = G.mapping(torch.as_tensor(zs.reshape(-1, G.z_dim), device=dev),
                           torch.as_tensor(FRONT_POSE, device=dev)[None].expand(zs.shape[0] * K, -1))
    key_ws = key_ws.cpu().numpy().reshape(tr["clips"], K, *key_ws.shape[1:])
    st = types.SimpleNamespace(
        G=G, dev=dev, shapes=shapes, zs=zs, chunk=chunk, total=total,
        ws=[interpolate(k, wf) for k in key_ws],
        cs=np.stack([orbit_label(fi, total) for fi in range(total)]),
        rp=common.render_params(run), mode=tr["image_mode"], render=gen_videos.render_chunks,
        frames=0, kept={}, keep_rng=np.random.default_rng([run.seed, 1]),
        trace_units=tr["trace_units"])
    for _ in range(tr["warmup_calls"]):
        st.render(G, st.ws[0], st.cs, st.rp, st.mode, chunk, dev)
    common.synchronize(run.device)
    return st


def unit(st, i: int) -> None:
    tiles = st.render(st.G, st.ws[i % len(st.ws)], st.cs, st.rp, st.mode, st.chunk, st.dev)
    st.frames += len(tiles)
    j = int(st.keep_rng.integers(st.total // st.chunk))
    st.kept[i] = (i % len(st.ws), j, tiles[j * st.chunk:(j + 1) * st.chunk])


def snapshot(st) -> dict:
    return {"frames": st.frames}


def finish(st, run, win) -> dict:
    n = win.snapshot["frames"]
    return {"attempted": st.frames, "failed": 0, "e2e": {"frames_per_s": n / win.seconds},
            "work": {"g_frames": n, "k1_batch": st.chunk}}


def reference_tiles(st, run, P, arch, clip: int, j: int, q=ref.exact) -> np.ndarray:
    """Chunk j of clip `clip` as the reference renders it from the same latents."""
    tr, dev = run.traffic, torch.device(run.device)
    z = torch.as_tensor(st.zs[clip], device=dev)
    key = ref.with_tf32_off(ref.mapping, P, arch, z,
                            torch.as_tensor(FRONT_POSE, device=dev)[None].expand(z.shape[0], -1))
    ws = interpolate(key.cpu().numpy(), tr["w_frames"])[j * st.chunk:(j + 1) * st.chunk]
    cs = st.cs[j * st.chunk:(j + 1) * st.chunk]
    return ref.with_tf32_off(ref.frame_u8, P, arch, torch.as_tensor(ws, device=dev),
                             torch.as_tensor(cs, device=dev), q)


def gaps(pairs: list) -> dict:
    """Over (got, want) tiles [K, R, 2R, 3]: the mean |uint8 difference| of
    the images, and the share of seg pixels whose class colour differs."""
    img_abs, seg_diff = [], []
    for got, want in pairs:
        got = np.stack(got)
        R = want.shape[1]
        img_abs.append(np.abs(got[:, :, :R].astype(np.int16) - want[:, :, :R]).mean())
        seg_diff.append((got[:, :, R:] != want[:, :, R:]).any(-1).mean())
    return {"img": float(np.mean(img_abs)), "seg": float(np.mean(seg_diff))}


def gap_ratios(got: list, want: list, stated: list) -> dict:
    """The gaps of `got` to the fp32 reference, each over the gap of the
    reference at the configuration's stated precision: at random weights how
    far rounding carries differs from seed to seed by 4x, the ratio does not."""
    g, s = gaps(list(zip(got, want))), gaps(list(zip(stated, want)))
    return {"img_gap_ratio": g["img"] / max(s["img"], 1e-9),
            "seg_gap_ratio": g["seg"] / max(s["seg"], 1e-9)}


def check(st, run, win) -> dict:
    """The compared chunks, drawn from the seed, against the fp32 reference."""
    rng = np.random.default_rng([run.seed, 2])
    calls = sorted(st.kept)
    picks = rng.choice(len(calls), size=min(run.traffic["compare_calls"], len(calls)), replace=False)
    wanted = [st.kept[calls[p]] for p in sorted(picks)]
    del st.G
    st.kept = None
    common.free(run.device)
    P, arch = common.reference_params(run, st.shapes)
    dtype = run.config["generator"]["dtype"]

    def tiles(q):
        return [reference_tiles(st, run, P, arch, clip, j, q) for clip, j, _ in wanted]

    want, stated = tiles(ref.exact), tiles(ref.STATED[dtype])
    out = gap_ratios([got for _, _, got in wanted], want, stated)
    if run.control:
        lower = gap_ratios(tiles(ref.LOWER[dtype]), want, stated)
        out.update({"control.lower." + k: v for k, v in lower.items()})
    return out
