"""Smoke run of the PyTorch port on one CUDA card: build, check and time K1,
then drive the free-view frame at the flagship width.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device  - needs CUDA; prints the card's name and power limit (nvidia-smi)
  2. build   - nvcc builds ide3d_tpu_torch/csrc/ray_march.cu for sm_90a
  3. kernel  - K1 against its plain version at B=1, R=4096, S=96+96, C=51,
               for each option (softplus, relu, last_back, white_back, density
               noise): fp32 vals (max abs err <= 1e-4), bf16 vals (<= 1e-3);
               saturated density (finite, wsum = 1 +- 1e-4); other shapes with
               ties, staged and streamed (<= 1e-4); then K1 and plain timed at
               B=1 and B=3 (bf16, the frame's shape) from CUDA graphs of many
               calls, beside the byte bound at 3.35 TB/s, and K1 eager, one
               call at a time (the wrapper's host time included)
  4. fp32    - GeneratorConfig(dtype="float32") at batch 1 on the card against
               the same weights on the CPU (plain paths), max abs err <= 3e-5
               x the output's scale
  5. frame   - GeneratorConfig() from init(seed=0), bf16, 96+96 samples: the
               three-yaw batch of gen_images for a few seeds; shapes, finite
               values, the K1 launch count, frame time, peak memory; then one
               frame's captured K1 inputs through kernel and plain
Then one JSON line with the kernels, and last {"ok": true, "device": {...}}.
In that line `ms` and `plain_ms` are device times per call at B=3 from the
CUDA graphs; `eager_ms` is the time between CUDA events around one eager call
and `host_ms` the host's time in that call, medians at B=3; `b1` holds the
same at B=1.
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
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
K1_OPTIONS = (
    {}, {"clamp_mode": "relu"}, {"last_back": True}, {"white_back": True}, {"noise": True},
)


def graph_ms(fns, calls: int, runs: int = TIMED_RUNS) -> float:
    """Device time of one call, in ms: the median over `runs` replays of a CUDA
    graph that holds `calls` calls cycling through `fns`, timed by CUDA events.
    The graph keeps the host's launch overhead out of the time."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    # A matmul captured on the graph's stream leaves a cuBLAS workspace
    # (32 MiB on Hopper) allocated for that stream; free it, or it counts in
    # the frame's peak memory.
    torch._C._cuda_clearCublasWorkspaces()
    return statistics.median(times)


def eager_ms(fn, runs: int = TIMED_RUNS) -> tuple[float, float]:
    """One eager call at a time, the card idle before each: the median time
    between CUDA events recorded around the call (the wrapper's host time plus
    the kernel's), and the median host time until the call returns, in ms."""
    fn()
    torch.cuda.synchronize()
    events, host = [], []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        events.append(start.elapsed_time(end))
    return statistics.median(events), statistics.median(host)


def k1_bytes(args) -> int:
    """Bytes K1 must move: each input read once, each output written once."""
    B, R, _, c1 = args[1].shape
    return sum(t.numel() * t.element_size() for t in args if t is not None) + B * R * (c1 + 1) * 4


def max_err(a, b) -> float:
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


def k1_inputs(gen, dtype, sigma=None, B=1, sorted_halves=False):
    """K1's inputs at the frame's shape (R=4096, S=96+96, C=51) on the card.
    `sorted_halves` gives each half ascending depths, as the deterministic
    render does; otherwise they are unsorted."""
    R, S, C = 4096, 96, 51
    dev = "cuda"

    def half():
        z = torch.rand(B, R, S, 1, generator=gen) * 1.05 + 2.25
        if sorted_halves:
            z = torch.sort(z, dim=2).values
        v = torch.randn(B, R, S, C + 1, generator=gen)
        v[..., -1] = v[..., -1] * 10 if sigma is None else sigma
        return z.to(dev), v.to(dev, dtype).contiguous()

    (za, va), (zb, vb) = half(), half()
    norm = (torch.rand(B, R, 1, generator=gen) * 0.2 + 0.9).to(dev)
    return za, va, zb, vb, norm


def _k1_options(opts, args, gen) -> dict:
    """Keyword arguments of one K1 option set; noise is drawn for these inputs."""
    kw = {k: v for k, v in opts.items() if k != "noise"}
    if opts.get("noise"):
        B, R = args[0].shape[:2]
        kw["noise"] = (torch.randn(B, R, args[0].shape[2] + args[2].shape[2], generator=gen)
                       * 2.0).cuda()
    return kw


def phase_kernel(smi: str) -> dict:
    from ide3d_tpu_torch.ops.ray_march import sort_integrate, sort_integrate_plain

    gen = torch.Generator().manual_seed(0)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-3)):
        args = k1_inputs(gen, dtype)
        for opts in K1_OPTIONS:
            kw = _k1_options(opts, args, gen)
            got, ref = sort_integrate(*args, **kw), sort_integrate_plain(*args, **kw)
            torch.cuda.synchronize()
            _check_finite(f"K1 kernel {opts}", got)
            per = [float((g - r).abs().max()) for g, r in zip(got, ref)]
            if max(per) > tol:
                raise RuntimeError(f"K1 vs plain ({dtype}, {opts}): max abs err "
                                   f"feat/depth/wsum {per} > {tol}")
            errs[f"{str(dtype).split('.')[-1]} {','.join(opts) or 'softplus'}"] = max(per)

    sat = k1_inputs(gen, torch.float32, sigma=100.0)
    feat, depth, wsum = sort_integrate(*sat)
    torch.cuda.synchronize()
    _check_finite("K1 saturated", (feat, depth, wsum))
    sat_err = float((wsum - 1.0).abs().max())
    if sat_err > 1e-4:
        raise RuntimeError(f"K1 saturated: |wsum - 1| = {sat_err}")

    # Shapes off the main path, depths rounded to 1/8 so that many samples tie
    # within and across halves, each with one option set: uneven and 1-sample
    # halves, C+1 up to 256 (streamed in row chunks), and staged shapes whose
    # channel sums take 16-byte vectors over 1, 2 or 8 rows or one channel a lane.
    edge_err = 0.0
    for n, (B, R, sa, sb, C, dtype) in enumerate((
            (2, 37, 5, 130, 3, torch.float32), (1, 5, 1, 1, 1, torch.float32),
            (1, 33, 200, 56, 255, torch.float32), (3, 100, 96, 96, 51, torch.bfloat16),
            (2, 45, 8, 16, 8, torch.bfloat16), (2, 50, 32, 32, 159, torch.float32),
            (1, 40, 8, 12, 3, torch.bfloat16), (2, 70, 64, 128, 51, torch.float32))):
        halves = []
        for s in (sa, sb):
            z = torch.round((torch.rand(B, R, s, 1, generator=gen) * 1.05 + 2.25) * 8) / 8
            v = torch.randn(B, R, s, C + 1, generator=gen)
            halves += [z.cuda(), v.to("cuda", dtype)]
        norm = (torch.rand(B, R, 1, generator=gen) + 0.5).cuda()
        args = (*halves, norm)
        for opts in (K1_OPTIONS[0], K1_OPTIONS[1 + n % (len(K1_OPTIONS) - 1)]):
            kw = _k1_options(opts, args, gen)
            edge_err = max(edge_err, max_err(sort_integrate(*args, **kw),
                                             sort_integrate_plain(*args, **kw)))
    if edge_err > 1e-4:
        raise RuntimeError(f"K1 vs plain off the main path's shapes: max abs err {edge_err}")

    # Times at the frame's shape and dtype, sorted halves as the frame has them.
    # Two input sets in turn, so that B=1 (86 MB) does not run from the 50 MB L2.
    timing = {}
    for B in (1, 3):
        sets = [k1_inputs(gen, torch.bfloat16, B=B, sorted_halves=True) for _ in range(2)]
        kern = [lambda a=a: sort_integrate(*a) for a in sets]
        plain = [lambda a=a: sort_integrate_plain(*a) for a in sets]
        t = [graph_ms(kern, 20), graph_ms(plain, 4), graph_ms(plain, 4), graph_ms(kern, 20)]
        eager, host = eager_ms(kern[0])
        nbytes = k1_bytes(sets[0])
        bound_ms = nbytes / HBM_BYTES_PER_MS
        timing[B] = {"ms": min(t[0], t[3]), "plain_ms": min(t[1], t[2]), "eager_ms": eager,
                     "host_ms": host, "bytes": nbytes, "bound_ms": bound_ms,
                     "bound_share": bound_ms / min(t[0], t[3])}
        print(f"kernel: K1 bf16 B={B} R=4096 S=96+96 C=51: kernel {t[0]:.4f}/{t[3]:.4f} ms, "
              f"plain {t[1]:.4f}/{t[2]:.4f} ms; {nbytes} B, bound {bound_ms * 1e3:.2f} us at "
              f"3.35 TB/s, {100 * timing[B]['bound_share']:.1f}% of the bound; eager call "
              f"{eager:.4f} ms, of it host {host:.4f} ms ({smi})", flush=True)
        del sets, kern, plain
    print(f"kernel: K1 vs plain max abs err {errs}; saturated |wsum-1| {sat_err:.3g}; "
          f"edge shapes {edge_err:.3g}", flush=True)
    return {"max_abs_err": max(edge_err, sat_err, *errs.values()), "timing": timing}


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

    def capture(*args, **kw):
        captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    renderer.sort_integrate = capture
    try:
        gen_images.synth_views(G, ws[SEEDS[0]], cams, rp)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    ((args, kw),) = captured
    with torch.inference_mode():
        frame_err = max_err(ray_march.sort_integrate(*args, **kw),
                            ray_march.sort_integrate_plain(*args, **kw))
    if frame_err > 1e-3:
        raise RuntimeError(f"K1 vs plain on a frame's inputs: max abs err {frame_err}")
    # Rays whose coarse / fine half arrives sorted take the binary-search rank.
    sorted_share = [float((z[:, :, 1:] >= z[:, :, :-1]).all(2).float().mean())
                    for z in (args[0], args[2])]
    with torch.inference_mode():
        k1_frame_ms = graph_ms([lambda: ray_march.sort_integrate(*args, **kw)], 20)

    print(f"frame: GeneratorConfig() bf16 96+96, batch of 3 yaws x {len(SEEDS)} seeds: "
          f"img {tuple(outs[0][0].shape)} seg {tuple(outs[0][1].shape)} finite; "
          f"frame ms {[round(t, 3) for t in times]} median {statistics.median(times):.3f}; "
          f"peak {peak_gib:.3f} GiB; init {init_s:.1f} s; K1 launches {launches}; "
          f"K1 on captured frame inputs (vals {args[1].dtype}, {tuple(args[1].shape)}+"
          f"{tuple(args[3].shape)}) max abs err vs plain {frame_err:.3g}, "
          f"{k1_frame_ms:.4f} ms; rays with a sorted coarse / fine half {sorted_share}", flush=True)
    return {"launches": launches, "frame_err": frame_err, "k1_frame_ms": k1_frame_ms}


def main() -> None:
    smi = phase_device()
    phase_build()
    k = phase_kernel(smi.splitlines()[0])
    phase_fp32()
    f = phase_frame()
    main_path, b1 = k["timing"][3], k["timing"][1]  # the frame runs K1 at B=3
    print(json.dumps({"kernels": [{
        "name": "sort_integrate",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "launches": f["launches"],
        "max_abs_err": max(k["max_abs_err"], f["frame_err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "eager_ms": main_path["eager_ms"],
        "host_ms": main_path["host_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bytes": main_path["bytes"],
        "bound_share": main_path["bound_share"],
        "b1": b1,
        "ms_on_frame_inputs": f["k1_frame_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
