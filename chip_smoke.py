"""Smoke run of the PyTorch port on one CUDA card: build, check and time K1,
then drive the free-view frame at the flagship width.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device  - needs CUDA; prints the card's name and power limit (nvidia-smi)
  2. build   - nvcc builds ide3d_tpu_torch/csrc/ray_march.cu for sm_90a
  3. kernel  - K1 against its plain version at B=1, R=4096, S=96+96, C=51:
               fp32 vals (max abs err <= 1e-4), bf16 vals (<= 1e-3), saturated
               density (finite, wsum = 1 +- 1e-4), and a few other shapes with
               ties (<= 1e-4); CUDA-event times
  4. fp32    - GeneratorConfig(dtype="float32") at batch 1 on the card against
               the same weights on the CPU (plain paths), max abs err <= 3e-5
               x the output's scale
  5. frame   - GeneratorConfig() from init(seed=0), bf16, 96+96 samples: the
               three-yaw batch of gen_images for a few seeds; shapes, finite
               values, the K1 launch count, frame time, peak memory; then one
               frame's captured K1 inputs through kernel and plain
Then one JSON line with the kernels, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEEDS = (0, 1, 2)
TIMED_RUNS = 25


def _cuda_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    """Median time of fn() on the current stream, from CUDA events, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def _check_finite(name, tensors) -> None:
    for t in tensors:
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{name}: non-finite output")


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return smi


def phase_build() -> None:
    from ide3d_tpu_torch import _build

    t0 = time.perf_counter()
    lib, log = _build.build("ray_march")
    used = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
    print(f"build: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{lib.name} in {time.perf_counter() - t0:.1f} s"
          f"{' (cached)' if not log else ''}; ptxas: {' | '.join(used) or 'n/a'}", flush=True)


def _k1_inputs(gen, dtype, sigma=None):
    B, R, S, C = 1, 4096, 96, 51
    dev = "cuda"

    def half():
        z = (torch.rand(B, R, S, 1, generator=gen) * 1.05 + 2.25).to(dev)
        v = torch.randn(B, R, S, C + 1, generator=gen)
        v[..., -1] = v[..., -1] * 10 if sigma is None else sigma
        return z, v.to(dev, dtype).contiguous()

    (za, va), (zb, vb) = half(), half()
    norm = (torch.rand(B, R, 1, generator=gen) * 0.2 + 0.9).to(dev)
    return za, va, zb, vb, norm


def phase_kernel() -> dict:
    from ide3d_tpu_torch.ops.ray_march import sort_integrate, sort_integrate_plain

    gen = torch.Generator().manual_seed(0)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        args = _k1_inputs(gen, dtype)
        got, ref = sort_integrate(*args), sort_integrate_plain(*args)
        torch.cuda.synchronize()
        _check_finite("K1 kernel", got)
        per = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        if max(per) > tol:
            raise RuntimeError(f"K1 vs plain ({dtype}): max abs err feat/depth/wsum {per} > {tol}")
        errs[str(dtype).split(".")[-1]] = per

    sat = _k1_inputs(gen, torch.float32, sigma=100.0)
    feat, depth, wsum = sort_integrate(*sat)
    torch.cuda.synchronize()
    _check_finite("K1 saturated", (feat, depth, wsum))
    sat_err = float((wsum - 1.0).abs().max())
    if sat_err > 1e-4:
        raise RuntimeError(f"K1 saturated: |wsum - 1| = {sat_err}")

    # Shapes off the main path: uneven halves, 1-sample halves, C+1 up to 256
    # channels, depths rounded to 1/8 so that many samples tie across halves.
    edge_err = 0.0
    for B, R, sa, sb, C, dtype in ((2, 37, 5, 130, 3, torch.float32), (1, 5, 1, 1, 1, torch.float32),
                                   (1, 33, 200, 56, 255, torch.float32),
                                   (3, 100, 96, 96, 51, torch.bfloat16)):
        halves = []
        for s in (sa, sb):
            z = torch.round((torch.rand(B, R, s, 1, generator=gen) * 1.05 + 2.25) * 8) / 8
            v = torch.randn(B, R, s, C + 1, generator=gen)
            halves += [z.cuda(), v.to("cuda", dtype)]
        norm = (torch.rand(B, R, 1, generator=gen) + 0.5).cuda()
        args = (*halves, norm)
        edge_err = max(edge_err, _max_err(sort_integrate(*args), sort_integrate_plain(*args)))
    if edge_err > 1e-4:
        raise RuntimeError(f"K1 vs plain off the main path's shapes: max abs err {edge_err}")

    args = _k1_inputs(gen, torch.bfloat16)  # the main path's dtype
    plain_ms = _cuda_ms(lambda: sort_integrate_plain(*args))
    ms = _cuda_ms(lambda: sort_integrate(*args))
    plain_ms2 = _cuda_ms(lambda: sort_integrate_plain(*args))
    ms2 = _cuda_ms(lambda: sort_integrate(*args))
    print(f"kernel: K1 max abs err feat/depth/wsum fp32 {errs['float32']} bf16 {errs['bfloat16']}; "
          f"saturated |wsum-1| {sat_err:.3g}; edge shapes {edge_err:.3g}; bf16 B=1 R=4096 S=192 C=51: kernel {ms:.4f}/{ms2:.4f} ms, "
          f"plain {plain_ms:.4f}/{plain_ms2:.4f} ms (median of {TIMED_RUNS}, two rounds)", flush=True)
    return {"max_abs_err": max(edge_err, *(max(v) for v in errs.values())), "ms": min(ms, ms2),
            "plain_ms": min(plain_ms, plain_ms2)}


def phase_fp32() -> None:
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    z = torch.as_tensor(np.random.RandomState(0).randn(1, 512), dtype=torch.float32)
    c = torch.as_tensor(CANONICAL_POSE_25)[None]
    outs = {}
    for dev in ("cpu", "cuda"):
        G = Ide3dGenerator(GeneratorConfig(dtype="float32")).init(seed=0).to(dev).eval()
        with torch.inference_mode():
            outs[dev] = G(z.to(dev), c.to(dev), return_all=True)
    # fp32 with TF32 off on both sides: only the order of sums differs.
    err, scale = {}, {}
    for k in ("img", "seg", "depth", "weights_sum"):
        ref = outs["cpu"][k]
        err[k] = float((outs["cuda"][k].cpu() - ref).abs().max())
        scale[k] = max(1.0, float(ref.abs().max()))
    _check_finite("fp32 frame", [outs["cuda"][k] for k in err])
    if any(err[k] > 3e-5 * scale[k] for k in err):
        raise RuntimeError(f"fp32 frame cuda vs cpu: max abs err {err}, output scale {scale}")
    print(f"fp32: GeneratorConfig(dtype=float32) batch 1, cuda (K1) vs cpu (plain): max abs err "
          f"{err} at output scale {scale} (limit 3e-5 x scale)", flush=True)


def phase_frame() -> dict:
    from ide3d_tpu_torch.apps import gen_images
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.render.renderer import RenderParams

    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    G = Ide3dGenerator(cfg).init(seed=0).to("cuda").eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rp = RenderParams(img_size=cfg.render_size, num_steps=96, hierarchical=True)
    cams = gen_images.yaw_cameras("cuda")
    cs = torch.as_tensor(CANONICAL_POSE_25, device="cuda")[None]
    with torch.inference_mode():
        ws = {s: G.mapping(torch.as_tensor(np.random.RandomState(s).randn(1, cfg.z_dim),
                                           dtype=torch.float32, device="cuda"), cs) for s in SEEDS}
    gen_images.synth_views(G, ws[SEEDS[0]], cams, rp)  # warm-up: cuDNN heuristics, allocator
    torch.cuda.synchronize()

    # The main path, counted: the gen_images batch for each seed.
    torch.cuda.reset_peak_memory_stats()
    ray_march.sort_integrate.launches = 0
    times, outs = [], []
    for s in SEEDS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        img, seg, seg_rgb = gen_images.synth_views(G, ws[s], cams, rp)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        outs.append((img, seg, seg_rgb))
    launches = ray_march.sort_integrate.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    R = cfg.img_resolution
    for img, seg, seg_rgb in outs:
        if tuple(img.shape) != (3, R, R, 3) or tuple(seg.shape) != (3, R, R, 19):
            raise RuntimeError(f"frame shapes img {tuple(img.shape)} seg {tuple(seg.shape)}")
        _check_finite("frame", (img, seg))
        if torch.equal(img[0], img[2]):
            raise RuntimeError("frame: the -0.5 and +0.5 yaw views are identical")
    if launches != len(SEEDS):
        raise RuntimeError(f"K1 launched {launches} times for {len(SEEDS)} frames")

    # One frame's K1 inputs, captured at the renderer's call, through kernel and plain.
    captured = []

    def capture(*args):
        captured.append(args)
        return ray_march.sort_integrate(*args)

    renderer.sort_integrate = capture
    try:
        gen_images.synth_views(G, ws[SEEDS[0]], cams, rp)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    (args,) = captured
    with torch.inference_mode():
        frame_err = _max_err(ray_march.sort_integrate(*args), ray_march.sort_integrate_plain(*args))
    if frame_err > 1e-3:
        raise RuntimeError(f"K1 vs plain on a frame's inputs: max abs err {frame_err}")

    print(f"frame: GeneratorConfig() bf16 96+96, batch of 3 yaws x {len(SEEDS)} seeds: "
          f"img {tuple(outs[0][0].shape)} seg {tuple(outs[0][1].shape)} finite; "
          f"frame ms {[round(t, 3) for t in times]} median {statistics.median(times):.3f}; "
          f"peak {peak_gib:.3f} GiB; init {init_s:.1f} s; K1 launches {launches}; "
          f"K1 on captured frame inputs (vals {args[1].dtype}, {tuple(args[1].shape)}+"
          f"{tuple(args[3].shape)}) max abs err vs plain {frame_err:.3g}", flush=True)
    return {"launches": launches, "frame_err": frame_err}


def main() -> None:
    phase_device()
    phase_build()
    k = phase_kernel()
    phase_fp32()
    f = phase_frame()
    print(json.dumps({"kernels": [{
        "name": "sort_integrate",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "launches": f["launches"],
        "max_abs_err": max(k["max_abs_err"], f["frame_err"]),
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
