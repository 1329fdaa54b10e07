"""Render interpolation orbit videos (the port's gen_videos).

Usage:
    python -m ide3d_tpu_torch.apps.gen_videos --network random:0 --seeds 0,1,2,3 \
        --grid 2x2 --output out/video.mp4 --image-mode image_seg

Same CLI as `python -m ide3d_tpu.apps.gen_videos`, plus `--device` (the CUDA
card unless asked otherwise). Periodic cubic-spline interpolation through the
seeds' w+ while the camera orbits (yaw and pitch sinusoids around the front
pose); modes image | image_seg | image_depth put the colorized seg or the
shaded depth beside each image. Frames go frame-major, then tile by tile in
raster order.

Each chunk of `--chunk` frames renders as one batch through G.synthesis (one
K1 launch per chunk), and the uint8 image, the seg colours and the depth
(normalized per frame, resized bilinearly) are made on the device. The host
copy of chunk i (pinned memory, non-blocking) overlaps the rendering of chunk
i+1. `main` returns {"path", "frames", "ms_per_frame"}, the last timed around
the chunk loop (CUDA events on the card).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..render.camera import CANONICAL_POSE_25, look_at_pose, make_label_25
from ..render.renderer import RenderParams
from ..utils.seg import mask2color


def orbit_label(fi: int, total: int) -> np.ndarray:
    """The camera label [25] of frame `fi` of `total`: yaw 0.4 sin, pitch
    0.05 cos of the orbit phase, radius 2.7, looking at (0, 0, 0.2)."""
    yaw = 0.4 * math.sin(2 * math.pi * fi / total)
    pitch = 0.05 * math.cos(2 * math.pi * fi / total)
    c2w = look_at_pose(math.pi / 2 + yaw, math.pi / 2 - pitch, [0.0, 0.0, 0.2], radius=2.7)
    return make_label_25(c2w).numpy().astype(np.float32).reshape(25)


def video_work(G, seeds, gw: int, gh: int, num_keyframes: int, w_frames: int,
               truncation_psi: float = 1.0, truncation_cutoff=None,
               device: torch.device | str = "cuda"):
    """The frames' latents and cameras, frame-major then tile raster order:
    (ws [N, num_ws, w_dim] float32, labels [N, 25] float32), N = frames * tiles."""
    from scipy import interpolate as sinterp

    dev = torch.device(device)
    zs = torch.as_tensor(np.stack([np.random.RandomState(s).randn(G.z_dim) for s in seeds]),
                         dtype=torch.float32, device=dev)
    cs = torch.as_tensor(CANONICAL_POSE_25, device=dev)[None].expand(len(seeds), -1)
    with torch.inference_mode():
        ws = G.mapping(zs, cs, truncation_psi=truncation_psi, truncation_cutoff=truncation_cutoff)
    ws = ws.cpu().numpy().reshape(gh, gw, num_keyframes, *ws.shape[1:])
    interps = {}
    for yi in range(gh):
        for xi in range(gw):
            x = np.arange(-num_keyframes * 2, num_keyframes * 2)
            y = np.tile(ws[yi, xi], [4, 1, 1])
            interps[(yi, xi)] = sinterp.interp1d(x, y, kind="cubic", axis=0)
    total = num_keyframes * w_frames
    work_ws, work_cs = [], []
    for fi in range(total):
        c = orbit_label(fi, total)
        for yi in range(gh):
            for xi in range(gw):
                work_ws.append(np.asarray(interps[(yi, xi)](fi / w_frames), np.float32))
                work_cs.append(c)
    return np.stack(work_ws), np.stack(work_cs)


def post(out: dict, image_mode: str, R: int):
    """The device epilogue of a chunk: (img uint8 [K,R,R,3], the mode's extra
    uint8 [K,R,R,3] or None): seg colours, or the depth normalized per frame,
    resized bilinearly (half-pixel centres) and repeated over 3 channels."""
    img8 = torch.round((out["img"] + 1) * 127.5).clamp(0, 255).to(torch.uint8)
    if image_mode == "image_seg":
        return img8, mask2color(out["seg"]).to(torch.uint8)
    if image_mode == "image_depth":
        d = out["depth"][..., 0]
        lo, hi = d.amin(dim=(1, 2), keepdim=True), d.amax(dim=(1, 2), keepdim=True)
        d = (d - lo) / torch.clamp(hi - lo, min=1e-8)
        d = F.interpolate(d[:, None], size=(R, R), mode="bilinear", align_corners=False)[:, 0]
        d8 = torch.round(d * 255).clamp(0, 255).to(torch.uint8)
        return img8, d8[..., None].expand(-1, -1, -1, 3)
    return img8, None


def render_chunks(G, work_ws: np.ndarray, work_cs: np.ndarray, rp: RenderParams,
                  image_mode: str, chunk: int, device: torch.device | str = "cuda") -> list:
    """Every frame of the work list as uint8 tiles [R, R or 2R, 3], rendered
    `chunk` at a time; the host copy of one chunk overlaps the next's rendering."""
    dev = torch.device(device)
    R = G.cfg.img_resolution
    K = max(1, chunk)
    starts = list(range(0, len(work_ws), K))
    cuda = dev.type == "cuda"

    def launch(start):
        ws_k = torch.as_tensor(work_ws[start:start + K], device=dev)
        cs_k = torch.as_tensor(work_cs[start:start + K], device=dev)
        with torch.inference_mode():
            out = G.synthesis(ws_k, cs_k, render_params=rp, return_all=True)
            pair = post(out, image_mode, R)
            if not cuda:
                return pair, None
            host = [None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in pair]
            for h, t in zip(host, pair):
                if t is not None:
                    h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    tiles = []
    pending = launch(starts[0])
    for si in range(len(starts)):
        nxt = launch(starts[si + 1]) if si + 1 < len(starts) else None
        (img8, ex8), done = pending
        if done is not None:
            done.synchronize()
        img8 = img8.numpy()
        ex8 = None if ex8 is None else ex8.numpy()
        for i in range(img8.shape[0]):
            tiles.append(img8[i] if ex8 is None else np.concatenate([img8[i], ex8[i]], axis=1))
        pending = nxt
    return tiles


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True, help="random:<seed>[:preset] or a snapshot dir")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--grid", default="1x1")
    ap.add_argument("--num-keyframes", type=int, default=None)
    ap.add_argument("--w-frames", type=int, default=24, help="frames per keyframe transition")
    ap.add_argument("--trunc", type=float, default=1.0, dest="truncation_psi")
    ap.add_argument("--truncation-cutoff", type=int, default=14)
    ap.add_argument("--image-mode", choices=["image", "image_seg", "image_depth"],
                    default="image")
    ap.add_argument("--num-steps", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=8,
                    help="frames rendered as one batch (one K1 launch)")
    ap.add_argument("--fps", type=int, default=24)
    ap.add_argument("--output", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .common import load_generator, parse_range, write_video

    dev = torch.device(args.device)
    G = load_generator(args.network, dev)
    gw, gh = (int(x) for x in args.grid.split("x"))
    seeds = parse_range(args.seeds)
    num_keyframes = args.num_keyframes
    if num_keyframes is None:
        num_keyframes = len(seeds) // (gw * gh)
    seeds = (seeds * ((num_keyframes * gw * gh) // len(seeds) + 1))[: num_keyframes * gw * gh]
    rp = RenderParams(img_size=G.cfg.render_size, num_steps=args.num_steps, hierarchical=True)

    work_ws, work_cs = video_work(G, seeds, gw, gh, num_keyframes, args.w_frames,
                                  args.truncation_psi, args.truncation_cutoff, dev)
    total = num_keyframes * args.w_frames
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    tiles = render_chunks(G, work_ws, work_cs, rp, args.image_mode, args.chunk, dev)
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        loop_ms = start.elapsed_time(end)
    else:
        loop_ms = (time.perf_counter() - t0) * 1e3

    frames = []
    per_frame = gh * gw
    for fi in range(total):
        block = tiles[fi * per_frame: (fi + 1) * per_frame]
        rows = [np.concatenate(block[yi * gw: (yi + 1) * gw], axis=1) for yi in range(gh)]
        frames.append(np.concatenate(rows, axis=0))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    out_path = write_video(args.output, frames, fps=args.fps)
    print(f"wrote {out_path} ({len(frames)} frames, {loop_ms / total:.3f} ms a frame)")
    return {"path": out_path, "frames": len(frames), "ms_per_frame": loop_ms / total}


if __name__ == "__main__":
    main()
