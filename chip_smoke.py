"""Smoke run of the PyTorch port on one CUDA card: build, check and time K1,
then drive the frame, the Painter, training and offline generation at the
flagship width.

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
  6. painter - phase 5's G with HybridEncoder(512, 10, 8, bf16).init(seed=1)
               behind PainterWebApp(PainterSession(...)), driven through
               handle() (no socket): meta, seed, two cached views, a new-view
               edit, two strokes, a view of the edited latent, a 12-frame orbit.
               Each request: status 200, 512^2 PNGs, finite images, and its
               exact K1 launches and generate_planes calls. A warm-up round
               with the finiteness checks, then timed rounds (wall time per
               route, PNG encoding included); CUDA-event times of a stroke, an
               uncached edit, a cached view and E alone; a cached view against
               G.synthesis (<= 1e-3), a stroke against the uncached edit
               (rec_ws <= 1e-3, uint8 within 1), the fp32 encoder on the card
               against the CPU (<= 3e-5 x scale)
  7. train   - K1's backward against autograd through its plain version at
               B=4, R=4096, S=96+96, C=51, fp32 and bf16 values, sorted and
               unsorted halves, each option: max abs err / max|grad| <= 1e-4
               (fp32), <= 1e-2 (bf16, the gradient rounded once to bf16);
               then timed (CUDA graphs) alone and with the forward, at the
               training render's layout (coarse half sorted, fine unsorted),
               beside the byte bounds, and the plain backward (events). The
               tiny fp32 preset's g-loss, d-loss and R1 (ADA at fixed draws)
               and their G and D gradients, card against CPU (<= 1e-4 x
               max). GeneratorConfig() + Discriminator(img_channels=25), bf16,
               batch 4, a synthetic 512² batch: 6 steps of
               make_gan_train_step at ada_p 0.2 (step 0 with R1) with each
               step's K1 forward and backward launches counted (1 and 1),
               finite stats, R1 on its cadence, G, D and G_ema moved; event
               times, one more (warm) R1 step, peak memory. Then
               apps.train_gan.main --preset full --batch 4 for 2 steps on an
               8-image 512² dataset, and --resume of its snapshot-final, which
               must restore every state dict, the step and ada_p.
  8. offline - GeneratorConfig() and the reference-compat slice G written as
               train_gan snapshots and loaded by load_generator; gen_videos on
               each (16 frames in 2 chunks, bf16): K1 once a chunk, the first
               chunk's K1 inputs through kernel and plain (<= 1e-3), frame 0
               against G.synthesis (within 1 uint8 level); the fp32 ref-compat
               frame card against CPU (<= 3e-5 x scale); extract_shapes at
               256^3 against an fp32 copy's grid (<= 3e-2 x max|sigma|) and that
               copy's first chunk card against CPU (<= 3e-5 x scale);
               render_mesh 128^3 with an 8-frame orbit: K1 once a frame, one
               frame's K1 inputs (fp32, 64+64) through kernel and plain (<= 1e-4)
Then one JSON line with the kernels, and last {"ok": true, "device": {...}}.
In that line K1's `ms` and `plain_ms` are device times per call at B=3 from
the CUDA graphs; `eager_ms` is the time between CUDA events around one eager
call and `host_ms` the host's time in that call, medians at B=3; `b1` holds
the same at B=1; `launches` counts phase 5's frames, `train_launches` phase
7's steps, `video_launches` and `mesh_launches` phase 8's runs; its
`max_abs_err` is the largest of phases 3, 5 and 8. The backward's `ms` is its graph time at B=4, `plain_ms` the plain
backward's event time, `launches` phase 7's steps, `max_abs_err` relative to
max|grad|.
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


def fp32_card_vs_cpu(cfg, seed: int, label: str) -> dict:
    """One fp32 frame of Ide3dGenerator(cfg).init(seed) at batch 1, the card
    (K1) against the CPU (plain paths) on the same weights, TF32 off on both
    sides: max abs err <= 3e-5 x the output's scale. Returns the errors."""
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    z = torch.as_tensor(np.random.RandomState(0).randn(1, cfg.z_dim), dtype=torch.float32)
    c = torch.as_tensor(CANONICAL_POSE_25)[None]
    outs = {}
    for dev in ("cpu", "cuda"):
        G = Ide3dGenerator(cfg).init(seed=seed).to(dev).eval()
        with torch.inference_mode():
            outs[dev] = G(z.to(dev), c.to(dev), return_all=True)
    err, scale = {}, {}
    for k in ("img", "seg", "depth", "weights_sum"):
        ref = outs["cpu"][k]
        err[k] = float((outs["cuda"][k].cpu() - ref).abs().max())
        scale[k] = max(1.0, float(ref.abs().max()))
    _check_finite(f"{label} fp32 frame", [outs["cuda"][k] for k in err])
    if any(err[k] > 3e-5 * scale[k] for k in err):
        raise RuntimeError(f"{label} fp32 frame cuda vs cpu: max abs err {err}, output scale {scale}")
    return {"err": err, "scale": scale}


def phase_fp32() -> None:
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    r = fp32_card_vs_cpu(GeneratorConfig(dtype="float32"), 0, "flagship")
    print(f"fp32: GeneratorConfig(dtype=float32) batch 1, cuda (K1) vs cpu (plain): max abs err "
          f"{r['err']} at output scale {r['scale']} (limit 3e-5 x scale)", flush=True)


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
    return {"launches": launches, "frame_err": frame_err, "k1_frame_ms": k1_frame_ms}, G


# The Painter's requests, in order: (route, method, path, query, payload,
# K1 launches, generate_planes calls). Every G pass launches K1 once; a view
# of the latent whose planes are cached generates none. "mask" payloads get
# the painted mask of that step.
PAINTER_REQUESTS = (
    ("meta", "GET", "/api/meta", None, None, 0, 0),
    ("seed", "POST", "/api/seed", None, {"seed": 3, "trunc": 0.7}, 1, 1),
    ("cached view", "GET", "/api/view", {"yaw": "0.3"}, None, 1, 0),
    ("cached view", "GET", "/api/view", {"yaw": "-0.3"}, None, 1, 0),
    ("uncached edit", "POST", "/api/edit", None, {"mask": 0, "yaw": 0.1}, 2, 2),
    ("stroke", "POST", "/api/edit", None, {"mask": 1, "yaw": 0.1}, 1, 1),
    ("stroke", "POST", "/api/edit", None, {"mask": 2, "yaw": 0.1}, 1, 1),
    ("view of edited latent", "GET", "/api/view", {"yaw": "0.1"}, None, 1, 1),
    ("orbit", "POST", "/api/orbit", None, {"type": "orbit", "stride": 10}, 12, 1),
)
PAINTER_ROUNDS = 3  # timed rounds of PAINTER_REQUESTS after the warm-up round
EVENT_RUNS = 7  # session calls timed by CUDA events, per kind


def painter_masks(seg_ids: np.ndarray, R: int) -> list:
    """The seed's class ids with a hair rectangle (class 13), then two more
    strokes on top: skin, then hair again."""
    m = [seg_ids.reshape(R, R).copy()]
    m[0][R // 8: R // 2, R // 4: 3 * R // 4] = 13
    for cls, box in ((1, (R // 2, 5 * R // 8, R // 3, R // 2)), (13, (R // 16, R // 8, R // 3, 2 * R // 3))):
        m.append(m[-1].copy())
        m[-1][box[0]:box[1], box[2]:box[3]] = cls
    return m


def _decode_png(b64: str, R: int) -> None:
    import base64
    import io

    import PIL.Image

    img = PIL.Image.open(io.BytesIO(base64.b64decode(b64)))
    img.load()
    if img.size != (R, R):
        raise RuntimeError(f"painter: PNG of size {img.size}, want {(R, R)}")


def painter_round(app, counts: dict, check: bool) -> list:
    """PAINTER_REQUESTS once through app.handle, every count set to 0 before
    each request and read after it. Returns [(route, wall ms, K1, planes)] and
    the orbit video's file type."""
    import base64

    from ide3d_tpu_torch.apps import painter
    from ide3d_tpu_torch.ops import ray_march

    R = app.session.G.cfg.img_resolution
    finite, masks, rows, ext = [], None, [], None
    to_u8 = painter._img_u8
    if check:  # every image a request renders, before its uint8 conversion
        painter._img_u8 = lambda img: (finite.append(torch.isfinite(img).all()), to_u8(img))[1]
    try:
        for route, method, path, query, payload, k1, planes in PAINTER_REQUESTS:
            if payload is not None and "mask" in payload:
                payload = dict(payload, mask=base64.b64encode(masks[payload["mask"]].reshape(-1)).decode())
            body = json.dumps(payload).encode() if payload is not None else b""
            ray_march.sort_integrate.launches = counts["planes"] = 0
            t0 = time.perf_counter()
            status, ctype, reply = app.handle(method, path, query or {}, body)
            ms = (time.perf_counter() - t0) * 1e3
            got = (ray_march.sort_integrate.launches, counts["planes"])
            if status != 200:
                raise RuntimeError(f"painter {route}: status {status}: {reply[:300]!r}")
            if got != (k1, planes):
                raise RuntimeError(f"painter {route}: K1 launches, generate_planes calls {got}, "
                                   f"want {(k1, planes)}")
            out = json.loads(reply)
            rows.append((route, ms, k1, planes))
            if "render" in out:
                _decode_png(out["render"], R)
            if "seg_ids" in out and len(base64.b64decode(out["seg_ids"])) != R * R:
                raise RuntimeError(f"painter {route}: seg_ids are not {R}x{R}")
            if route == "seed":
                masks = painter_masks(np.frombuffer(base64.b64decode(out["seg_ids"]), np.uint8), R)
            if route == "meta" and out["resolution"] != R:
                raise RuntimeError(f"painter meta: resolution {out['resolution']}")
            if route == "orbit":
                if out["frames"] != 12:
                    raise RuntimeError(f"painter orbit: {out['frames']} frames, want 12")
                ext = out["ext"]
                if out["ext"] == "gif":
                    import io

                    import PIL.Image

                    gif = PIL.Image.open(io.BytesIO(base64.b64decode(out["video"])))
                    if gif.n_frames != 12 or gif.size != (R, R):
                        raise RuntimeError(f"painter orbit: GIF {gif.n_frames} x {gif.size}")
    finally:
        painter._img_u8 = to_u8
    if check:
        images = sum(12 if r[0] == "orbit" else r[0] != "meta" for r in PAINTER_REQUESTS)
        if len(finite) != images or not all(bool(f) for f in finite):
            raise RuntimeError(f"painter: {len(finite)} images, finite {[bool(f) for f in finite]}")
        _check_finite("painter latent", [app.session.w])
    return rows, ext


def event_median_ms(fn, runs: int = EVENT_RUNS) -> float:
    """Median time between CUDA events around one call, the card idle before each."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_painter(G, smi: str) -> dict:
    import copy

    from ide3d_tpu_torch.apps.painter import PainterSession
    from ide3d_tpu_torch.apps.web_ui import PainterWebApp
    from ide3d_tpu_torch.models.encoder import HybridEncoder
    from ide3d_tpu_torch.utils.seg import COLOR_MAP, mask2onehot

    R = G.cfg.img_resolution
    n_geo = G.synthesis.num_ws_geo  # 8 geometry rows, 10 appearance rows, as web_ui builds E
    t0 = time.perf_counter()
    E = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo,
                      dtype=G.cfg.dtype).init(seed=1)
    sess = PainterSession(G=G, E=E.to("cuda").eval(), device="cuda")
    app = PainterWebApp(sess)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    S = G.synthesis
    counts = {"planes": 0}
    generate_planes = S.generate_planes

    def counted_planes(*args, **kw):
        counts["planes"] += 1
        return generate_planes(*args, **kw)

    S.generate_planes = counted_planes
    try:
        _, video_ext = painter_round(app, counts, check=True)  # warm-up, finiteness checks
        torch.cuda.reset_peak_memory_stats()
        rounds = [painter_round(app, counts, check=False)[0] for _ in range(PAINTER_ROUNDS)]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        del S.generate_planes
    wall, launches = {}, {}
    for rows in rounds:
        for route, ms, k1, _ in rows:
            wall.setdefault(route, []).append(ms)
            launches[route] = k1
    wall_med = {route: statistics.median(v) for route, v in wall.items()}
    k1_round = sum(r[2] for r in rounds[0])

    # Session calls alone, CUDA events: stroke (E + 1 G), uncached edit (E + 2 G),
    # cached view (1 G), E alone.
    masks = painter_masks(np.zeros(R * R, np.uint8), R)  # all background, then strokes
    sess.set_seed(3)
    sess.edit(masks[0], 0.1)
    ev = {"stroke": event_median_ms(lambda: sess.edit(masks[1], 0.1))}

    def uncached():
        sess._frame_cache = None
        sess.edit(masks[1], 0.1)

    ev["uncached edit"] = event_median_ms(uncached)
    sess.view(0.2)
    ev["cached view"] = event_median_ms(lambda: sess.view(0.2))
    gen_img = sess._frame_cache[2]
    seg_pm = mask2onehot(torch.from_numpy(masks[2]).cuda()[None]) * 2.0 - 1.0
    with torch.inference_mode():
        ev["E"] = event_median_ms(lambda: E(gen_img, seg_pm))

    # A cached view against the uncached frame of the same ws and c.
    sess.view(0.3)
    with torch.inference_mode():
        ref = G.synthesis(sess.w, sess.camera(0.3), return_seg=True)[0]
    view_err = float((sess._frame_cache[2] - ref).abs().max())
    _check_finite("painter cached view", [ref])
    if view_err > 1e-3:
        raise RuntimeError(f"painter: cached view vs G.synthesis max abs err {view_err} > 1e-3")

    # A stroke (frame cache) against the same edit without the frame cache.
    def edit_pair(use_cache):
        sess.set_seed(3)
        sess.edit(masks[0], 0.1)
        if not use_cache:
            sess._frame_cache = None
        rgb, seg = sess.edit(masks[1], 0.1)
        return rgb.astype(np.int32), seg.astype(np.int32), sess.w.clone()

    (rgb_c, seg_c, w_c), (rgb_u, seg_u, w_u) = edit_pair(True), edit_pair(False)
    _check_finite("painter stroke", [w_c, w_u])
    stroke_err = {"rec_ws": float((w_c - w_u).abs().max()),
                  "rgb": int(np.abs(rgb_c - rgb_u).max()), "seg": int(np.abs(seg_c - seg_u).max())}
    if stroke_err["rec_ws"] > 1e-3 or stroke_err["rgb"] > 1 or stroke_err["seg"] > 1:
        raise RuntimeError(f"painter: stroke vs uncached edit {stroke_err}")

    # The web UI's colour -> class-id inversion of a 512^2 seg, against the
    # nearest-colour search of the JAX package's web UI: same ids, host ms each.
    seg_color = sess.view(0.0)[1]
    t0 = time.perf_counter()
    ids = PainterWebApp._seg_ids(seg_color)
    lookup_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pal = COLOR_MAP.astype(np.int32)
    nearest = np.abs(seg_color.astype(np.int32)[:, :, None, :] - pal).sum(-1).argmin(-1)
    search_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(ids, nearest.reshape(-1)):
        raise RuntimeError("painter: palette lookup and nearest-colour search disagree")

    # The fp32 encoder at batch 1, card against CPU on the same weights (TF32 off).
    E32 = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo).init(seed=1)
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, R, R, 3)).astype(np.float32))
    seg = mask2onehot(torch.from_numpy(rng.randint(0, 19, (1, R, R)))) * 2.0 - 1.0
    with torch.inference_mode():
        e_ref = E32(img, seg)
        e_got = copy.deepcopy(E32).cuda()(img.cuda(), seg.cuda()).cpu()
    _check_finite("fp32 encoder", [e_got])
    e_scale = max(1.0, float(e_ref.abs().max()))
    e_err = float((e_got - e_ref).abs().max())
    if e_err > 3e-5 * e_scale:
        raise RuntimeError(f"painter: fp32 encoder cuda vs cpu max abs err {e_err}, scale {e_scale}")

    print(f"painter: {smi}; G {R}^2 {G.cfg.dtype} + HybridEncoder({R}, {G.num_ws - n_geo}, "
          f"{n_geo}, {G.cfg.dtype}) through "
          f"PainterWebApp.handle, {PAINTER_ROUNDS} rounds after a warm-up; wall ms per route "
          f"(median, PNG encoding included) {json.dumps({k: round(v, 3) for k, v in wall_med.items()})} "
          f"(samples {json.dumps({k: len(v) for k, v in wall.items()})}); "
          f"CUDA-event ms of the session call (median of {EVENT_RUNS}) "
          f"{json.dumps({k: round(v, 3) for k, v in ev.items()})}; peak {peak_gib:.3f} GiB; "
          f"init {init_s:.1f} s; K1 launches per request {json.dumps(launches)}, "
          f"{k1_round} a round, generate_planes as listed; orbit video .{video_ext}; seg colour -> "
          f"ids {lookup_ms:.3f} ms (nearest-colour search {search_ms:.3f} ms); cached view vs G.synthesis "
          f"{view_err:.3g}; stroke vs uncached edit {stroke_err}; fp32 E cuda vs cpu "
          f"{e_err:.3g} at scale {e_scale:.3g}", flush=True)
    return {"launches": launches, "per_round": k1_round, "wall_ms": wall_med, "event_ms": ev,
            "peak_gib": peak_gib, "max_abs_err": max(view_err, stroke_err["rec_ws"])}


TRAIN_STEPS = 6  # full-width train steps of phase 7; step 0 applies R1
TRAIN_ADA_P = 0.2


def k1_backward_bytes(args, cot) -> int:
    """Bytes K1's backward must move: the forward's inputs and the cotangents
    read once, a gradient as large as the values written once."""
    return (sum(t.numel() * t.element_size() for t in (*args, *cot) if t is not None)
            + args[1].numel() * args[1].element_size() + args[3].numel() * args[3].element_size())


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| over a list of tensor pairs."""
    scale = max(float(r.float().abs().max()) for r in ref)
    return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref)) / scale


def _k1_cotangents(gen, args):
    B, R, _, c1 = args[1].shape
    return [torch.randn(B, R, n, generator=gen).cuda() for n in (c1 - 1, 1, 1)]


def training_k1_sets(gen, n: int = 2) -> list:
    """n (args, cotangents) pairs at the training render's K1 inputs: bf16, B=4,
    coarse half sorted (jittered within its bins), fine half unsorted (random
    CDF positions)."""
    sets = []
    for _ in range(n):
        a = k1_inputs(gen, torch.bfloat16, B=4, sorted_halves=True)
        fine = k1_inputs(gen, torch.bfloat16, B=4)
        args = (a[0], a[1], fine[2], fine[3], a[4])
        sets.append((args, _k1_cotangents(gen, args)))
    return sets


def train_k1_backward(smi: str) -> dict:
    """K1's backward at the training render's shape (B=4) against autograd
    through the plain version, every option, then timed."""
    from ide3d_tpu_torch.ops.ray_march import (sort_integrate, sort_integrate_backward,
                                               sort_integrate_backward_plain)

    gen = torch.Generator().manual_seed(7)
    errs = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
        for sorted_halves in (False, True):
            args = k1_inputs(gen, dtype, B=4, sorted_halves=sorted_halves)
            cot = _k1_cotangents(gen, args)
            for opts in K1_OPTIONS:
                kw = _k1_options(opts, args, gen)
                got = sort_integrate_backward(*args, *cot, **kw)
                ref = sort_integrate_backward_plain(*args, *cot, **kw)
                torch.cuda.synchronize()
                _check_finite(f"K1 backward {opts}", [g.float() for g in got])
                err = rel_err(got, ref)
                name = f"{str(dtype).split('.')[-1]} {'sorted' if sorted_halves else 'unsorted'} " \
                       f"{','.join(opts) or 'softplus'}"
                if err > tol or any(g.dtype != r.dtype for g, r in zip(got, ref)):
                    raise RuntimeError(f"K1 backward vs plain ({name}): max abs err / max|grad| "
                                       f"{err} > {tol}")
                errs[name] = err
            del args, cot

    # Timed at the training render's inputs, two sets.
    sets = training_k1_sets(gen)
    bwd = [lambda s=s: sort_integrate_backward(*s[0], *s[1]) for s in sets]
    both = [lambda s=s: (sort_integrate(*s[0]), sort_integrate_backward(*s[0], *s[1])) for s in sets]
    fwd = [lambda s=s: sort_integrate(*s[0]) for s in sets]
    t_bwd = [graph_ms(bwd, 10), graph_ms(bwd, 10)]
    t_both = [graph_ms(both, 10), graph_ms(both, 10)]
    t_fwd = graph_ms(fwd, 10)
    plain = [event_median_ms(lambda: sort_integrate_backward_plain(*s[0], *s[1]), runs=5) for s in sets]
    bwd_bytes = k1_backward_bytes(*sets[0])
    fwd_bytes = k1_bytes(sets[0][0])
    out = {"max_abs_err": max(errs.values()), "errs": errs, "ms": min(t_bwd),
           "plain_ms": min(plain), "bound_ms": bwd_bytes / HBM_BYTES_PER_MS, "bytes": bwd_bytes,
           "fwd_bwd_ms": min(t_both), "fwd_bwd_bound_ms": (bwd_bytes + fwd_bytes) / HBM_BYTES_PER_MS,
           "fwd_ms_b4": t_fwd, "fwd_bound_ms_b4": fwd_bytes / HBM_BYTES_PER_MS}
    out["bound_share"] = out["bound_ms"] / out["ms"]
    print(f"train: K1 backward bf16 B=4 R=4096 S=96+96 C=51 (coarse sorted, fine unsorted): "
          f"{t_bwd[0]:.4f}/{t_bwd[1]:.4f} ms, {bwd_bytes} B, bound {out['bound_ms'] * 1e3:.1f} us "
          f"({100 * out['bound_share']:.1f}% of it); forward + backward {t_both[0]:.4f}/{t_both[1]:.4f} "
          f"ms, bound {out['fwd_bwd_bound_ms'] * 1e3:.1f} us; forward alone {t_fwd:.4f} ms "
          f"(bound {out['fwd_bound_ms_b4'] * 1e3:.1f} us); plain backward (autograd, event ms) "
          f"{[round(p, 4) for p in plain]} ({smi}); vs plain, max abs err / max|grad| "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} "
          f"(limits fp32 1e-4, bf16 1e-2)", flush=True)
    return out


def _tiny_gan(device: str):
    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    G = Ide3dGenerator(PRESETS["tiny"]).init(0).to(device)
    D = Discriminator(DiscriminatorConfig(img_resolution=32, img_channels=25, channel_base=512,
                                          channel_max=32, dtype="float32")).init(1).to(device)
    for name, p in G.named_parameters():  # non-zero layer noise: the const noise enters
        if name.endswith("noise_strength"):
            p.data.fill_(0.3)
    return G, D


def train_card_vs_cpu() -> dict:
    """fp32 tiny preset, the deterministic render, fixed z: g-loss, d-loss and
    R1 (through ADA at fixed draws) and their gradients, card against CPU."""
    import functools

    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
    from ide3d_tpu_torch.train import augment, gan

    rng = np.random.RandomState(3)
    B, R = 4, 32
    z = torch.from_numpy(rng.randn(B, 512).astype(np.float32))
    real_img = torch.from_numpy(rng.uniform(-1, 1, (B, R, R, 3)).astype(np.float32))
    real_seg = torch.from_numpy(rng.randint(0, 19, (B, R, R)).astype(np.uint8))
    c = torch.as_tensor(CANONICAL_POSE_25)[None].repeat(B, 1)
    tcfg = gan.GanTrainConfig(aug=augment.AugmentConfig(compute_dtype="float32"))
    gen = torch.Generator().manual_seed(5)
    Gm = augment._geometry_matrix(gen, 0.5, tcfg.aug, B, R, R)
    Cm = augment._color_matrix(gen, 0.5, tcfg.aug, B)
    res = {}
    for dev in ("cpu", "cuda"):
        G, D = _tiny_gan(dev)
        batch = gan.expand_compact_batch({"img": real_img.to(dev), "seg": real_seg.to(dev)})
        plain_in = functools.partial(gan.d_input, tcfg=tcfg, gen=None, ada_p=0.0)

        def ada_in(triple, Gm=Gm.to(dev), Cm=Cm.to(dev)):
            return torch.cat(augment.apply_augment(*triple, Gm, Cm, None, tcfg.aug), dim=-1)

        def grads(loss, module):  # the used parameters' gradients, in a fixed order
            gs = torch.autograd.grad(loss, list(module.parameters()), allow_unused=True)
            return [g for g in gs if g is not None]

        lg, _, fakes = gan.g_loss(G, D, z.to(dev), c.to(dev), tcfg, None, plain_in)
        real = gan.d_triple_real(batch["img"], batch["seg"], G.cfg.render_size)
        ld, _ = gan.d_loss(D, fakes, real, c.to(dev), plain_in)
        r1 = gan.r1_penalty(D, real, c.to(dev), ada_in)
        res[dev] = {"values": [lg.detach(), ld.detach(), r1.detach()], "g": grads(lg, G),
                    "d": grads(ld, D), "r1": grads(r1, D)}
    err = {"values": rel_err([v.cpu() for v in res["cuda"]["values"]], res["cpu"]["values"])}
    for k in ("g", "d", "r1"):
        err[k] = rel_err([g.cpu() for g in res["cuda"][k]], res["cpu"][k])
    print(f"train: tiny fp32 G/D, deterministic render, card (K1 + its backward) vs CPU (plain): "
          f"losses g/d/R1 {[round(float(v), 6) for v in res['cuda']['values']]}; max abs err / "
          f"max|x| {json.dumps({k: float(f'{v:.3g}') for k, v in err.items()})} (limit 1e-4)", flush=True)
    if max(err.values()) > 1e-4:
        raise RuntimeError(f"train: card vs CPU {err}")
    return err


def synthetic_batch(B: int, R: int, seed: int) -> dict:
    """A compact (uint8) batch of B random R² images and seg ids, with the
    three yaws of gen_images as cameras, on the card."""
    from ide3d_tpu_torch.apps import gen_images

    rng = np.random.RandomState(seed)
    cams = gen_images.yaw_cameras("cuda")
    return {"img": torch.from_numpy(rng.randint(0, 256, (B, R, R, 3), np.uint8)).cuda(),
            "seg": torch.from_numpy(rng.randint(0, 19, (B, R, R), np.uint8)).cuda(),
            "c": cams[torch.arange(B) % cams.shape[0]].contiguous()}


def train_full_width(smi: str) -> dict:
    """TRAIN_STEPS of make_gan_train_step at the flagship width, batch 4."""
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.train import gan

    B, cfg = 4, GeneratorConfig()
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution**2 / B)
    G = Ide3dGenerator(cfg).init(seed=0).cuda()
    D = Discriminator(DiscriminatorConfig(img_channels=gan.d_input_channels(tcfg, cfg))).init(1).cuda()
    state = gan.init_gan_state(G, D, tcfg)
    step = gan.make_gan_train_step(tcfg)
    batch = synthetic_batch(B, cfg.img_resolution, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = {n: [p.detach().clone() for p in m.parameters()] for n, m in (("G", G), ("D", D))}
    torch.cuda.synchronize()

    # The main path, counted: each step's K1 launches, forward and backward.
    torch.cuda.reset_peak_memory_stats()
    times, launches, stats = [], [], []
    for _ in range(TRAIN_STEPS):
        ray_march.sort_integrate.launches = ray_march.sort_integrate_backward.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, s = step(state, batch, gen, TRAIN_ADA_P)
        end.record()
        end.synchronize()
        launches.append((ray_march.sort_integrate.launches, ray_march.sort_integrate_backward.launches))
        times.append(start.elapsed_time(end))
        stats.append({k: float(v) for k, v in s.items()})
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    for i, s in enumerate(stats):
        if not all(np.isfinite(v) for v in s.values()):
            raise RuntimeError(f"train step {i}: non-finite stats {s}")
        if (s["r1_penalty"] > 0) != (i % tcfg.r1_interval == 0):
            raise RuntimeError(f"train step {i}: R1 {s['r1_penalty']} off its cadence")
    if any(n != (1, 1) for n in launches):
        raise RuntimeError(f"K1 (forward, backward) launches per train step {launches}, want (1, 1)")
    with torch.no_grad():
        moved = {n: sum(float((p - q).abs().sum()) for p, q in zip(m.parameters(), before[n]))
                 for n, m in (("G", G), ("D", D))}
        ema_gap = sum(float((p - q).abs().sum())
                      for p, q in zip(state.G_ema.parameters(), G.parameters()))
    if not all(v > 0 for v in moved.values()):
        raise RuntimeError(f"train: parameters did not move {moved}")
    if not ema_gap > 0:
        raise RuntimeError("train: G_ema equals G")

    # One more R1 step after the warm-up, timed alone.
    state.step = tcfg.r1_interval
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, s = step(state, batch, gen, TRAIN_ADA_P)
    end.record()
    end.synchronize()
    warm_r1 = start.elapsed_time(end)
    if not float(s["r1_penalty"]) > 0:
        raise RuntimeError("train: the warm R1 step applied no R1")
    med = statistics.median(times[1:])
    print(f"train: GeneratorConfig() bf16 96+96 + Discriminator(img_channels=25) bf16, batch 4, "
          f"ada_p {TRAIN_ADA_P}, {TRAIN_STEPS} steps of make_gan_train_step ({smi}): step ms "
          f"{[round(t, 3) for t in times]} (step 0 with R1 and the first calls; median of the "
          f"others {med:.3f}); a warm R1 step {warm_r1:.3f} ms; peak {peak_gib:.3f} GiB; K1 "
          f"(forward, backward) launches per step {launches}; losses per step "
          f"{[{k: round(v, 4) for k, v in s.items()} for s in stats]}; |dparam| sums {moved}", flush=True)
    return {"launches": launches, "step_ms": times, "median_ms": med, "r1_step_ms": times[0],
            "warm_r1_step_ms": warm_r1, "peak_gib": peak_gib, "imgs_per_s": B / med * 1e3}


def write_dataset(root: str, n: int, R: int) -> tuple:
    """n random R² PNGs with seg masks and a dataset.json of yaw cameras."""
    import os

    import PIL.Image

    from ide3d_tpu_torch.apps import gen_images

    imgs, segs = os.path.join(root, "imgs"), os.path.join(root, "segs")
    os.makedirs(imgs)
    os.makedirs(segs)
    rng = np.random.RandomState(1)
    cams = gen_images.yaw_cameras("cpu").numpy()
    labels = {}
    for i in range(n):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(os.path.join(imgs, name))
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(os.path.join(segs, name))
        label = cams[i % len(cams)].copy()
        label[[1, 2, 5, 6, 9, 10]] *= -1  # stored OpenCV-convention, flipped on load
        labels[name] = label.tolist()
    with open(os.path.join(imgs, "dataset.json"), "w") as f:
        json.dump({"labels": list(labels.items())}, f)
    return imgs, segs


def _same_state(a: dict, b: dict, path: str = "") -> None:
    """Every tensor of two (nested) state dicts equal; raises with the first difference."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise RuntimeError(f"resume: keys of {path} differ")
        for k in a:
            _same_state(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_state(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        if not torch.equal(a.cpu(), b.cpu()):
            raise RuntimeError(f"resume: {path} differs")
    elif a != b:
        raise RuntimeError(f"resume: {path} {a} != {b}")


def train_entry_point() -> dict:
    """apps.train_gan.main for 2 steps on an 8-image 512² dataset, then a
    resume of its final snapshot that restores every state dict."""
    import os
    import tempfile

    from ide3d_tpu_torch.apps import train_gan
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint

    with tempfile.TemporaryDirectory() as root:
        imgs, segs = write_dataset(root, 8, 512)
        common = ["--data", imgs, "--seg", segs, "--preset", "full", "--batch", "4",
                  "--kimg", "0.008", "--fixed-ada-p", str(TRAIN_ADA_P), "--device", "cuda"]
        t0 = time.perf_counter()
        first = train_gan.main(common + ["--outdir", os.path.join(root, "run")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        snap = os.path.join(root, "run", "snapshot-final")
        files = sorted(os.listdir(os.path.join(root, "run")))
        saved, meta = load_checkpoint(snap)
        if first.step != 2 or meta["step"] != 2 or meta["ada_p"] != TRAIN_ADA_P:
            raise RuntimeError(f"train_gan: step {first.step}, meta {meta.get('step')}, "
                               f"ada_p {meta.get('ada_p')}")
        resumed = train_gan.main(common + ["--outdir", os.path.join(root, "resumed"),
                                           "--resume", snap])
        for name in ("G", "D", "G_ema", "opt_g", "opt_d"):
            obj = getattr(resumed, name)
            _same_state(saved[name], obj.state_dict(), name)
            _same_state(getattr(first, name).state_dict(), obj.state_dict(), name)
        _same_state(saved["pl_mean"], resumed.pl_mean, "pl_mean")
        if resumed.step != 2:
            raise RuntimeError(f"train_gan --resume: step {resumed.step}, want 2")
    print(f"train: apps.train_gan.main --preset full --batch 4 --kimg 0.008 on 8 images: 2 steps "
          f"in {run_s:.1f} s (G and D init, grid and snapshot included), wrote {files}; --resume "
          f"of snapshot-final restored G, D, G_ema, opt_g, opt_d, pl_mean, step 2, ada_p "
          f"{meta['ada_p']}", flush=True)
    return {"run_s": run_s}


def phase_train(smi: str) -> dict:
    k = train_k1_backward(smi)
    e = train_card_vs_cpu()
    t = train_full_width(smi)
    a = train_entry_point()
    return {"k1_backward": k, "card_vs_cpu": e, "full": t, "app": a}


# Phase 8's video: 2 keyframes x 8 frames, rendered 8 frames a chunk (K1 once a chunk).
VIDEO_ARGS = ("--seeds", "0-1", "--grid", "1x1", "--num-keyframes", "2", "--w-frames", "8",
              "--chunk", "8", "--device", "cuda")
VIDEO_FRAMES, VIDEO_CHUNK = 16, 8
MESH_FRAMES = 8


def write_snapshot(path: str, cfg, seed: int) -> None:
    """Ide3dGenerator(cfg).init(seed) as train_gan writes a snapshot:
    {"G_ema": state dict} and the config, through io/checkpoint."""
    from ide3d_tpu_torch.io.checkpoint import save_checkpoint
    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    save_checkpoint(path, {"G_ema": Ide3dGenerator(cfg).init(seed=seed).state_dict()}, config=cfg,
                    step=0)


def offline_video(snap: str, mode: str, out: str, smi: str, label: str) -> dict:
    """apps.gen_videos.main on the snapshot, once to warm up and once counted:
    K1 once a chunk, 16 frames written, frame 0 within 1 uint8 level of
    G.synthesis on the same w+ and camera (in the chunk's batch, through the
    CLI's own epilogue); the warm-up's first-chunk K1 inputs, captured at the
    renderer's call, through kernel and plain (bf16 <= 1e-3, as phase 3)."""
    import os

    from ide3d_tpu_torch.apps import common, gen_videos
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.render.renderer import RenderParams

    argv = ["--network", snap, *VIDEO_ARGS, "--image-mode", mode, "--output", out]
    # Warm-up (cuDNN heuristics and the allocator at the chunk's shapes), with
    # the first chunk's K1 inputs captured; they are checked and freed before
    # the counted run, so that they do not count in its peak memory.
    captured = []

    def capture_k1(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    renderer.sort_integrate = capture_k1
    try:
        gen_videos.main(argv)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    ((args, kw),) = captured
    if tuple(args[1].shape) != (VIDEO_CHUNK, 4096, 96, 52) or args[1].dtype != torch.bfloat16:
        raise RuntimeError(f"{label} video: K1 took {args[1].dtype} {tuple(args[1].shape)}")
    with torch.inference_mode():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    torch.cuda.synchronize()
    _check_finite(f"{label} video K1", got)
    k1_err = max_err(got, ref)
    del got, ref, args, kw, captured
    if k1_err > 1e-3:
        raise RuntimeError(f"{label} video: K1 vs plain at bf16 ({VIDEO_CHUNK}, 4096, 96+96, 52) "
                           f"max abs err {k1_err} > 1e-3")

    written, real = [], common.write_video

    def capture(path, frames, fps=24):
        written.append(frames)
        return real(path, frames, fps)

    common.write_video = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ray_march.sort_integrate.launches = 0
        res = gen_videos.main(argv)
        launches = ray_march.sort_integrate.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        common.write_video = real
    (frames,) = written
    if launches != VIDEO_FRAMES // VIDEO_CHUNK:
        raise RuntimeError(f"{label} video: K1 launched {launches} times for "
                           f"{VIDEO_FRAMES // VIDEO_CHUNK} chunks")
    G = common.load_generator(snap, "cuda")
    R = G.cfg.img_resolution
    width = R if mode == "image" else 2 * R
    if len(frames) != VIDEO_FRAMES or any(f.shape != (R, width, 3) or f.dtype != np.uint8
                                          for f in frames):
        raise RuntimeError(f"{label} video: {len(frames)} frames of {frames[0].shape}")
    if not os.path.getsize(res["path"]) > 0:
        raise RuntimeError(f"{label} video: {res['path']} is empty")

    work_ws, work_cs = gen_videos.video_work(G, [0, 1], 1, 1, 2, 8, 1.0, 14, "cuda")
    rp = RenderParams(img_size=G.cfg.render_size, num_steps=96, hierarchical=True)
    with torch.inference_mode():
        o = G.synthesis(torch.as_tensor(work_ws[:VIDEO_CHUNK], device="cuda"),
                        torch.as_tensor(work_cs[:VIDEO_CHUNK], device="cuda"),
                        render_params=rp, return_all=True)
        _check_finite(f"{label} video frames", [o["img"], o["seg"], o["depth"]])
        img8, ex8 = gen_videos.post(o, mode, R)
    ref0 = img8[0] if ex8 is None else torch.cat([img8[0], ex8[0]], dim=1)
    err = int(np.abs(frames[0].astype(np.int32) - ref0.cpu().numpy().astype(np.int32)).max())
    if err > 1:
        raise RuntimeError(f"{label} video: frame 0 vs G.synthesis differs by {err} uint8 levels")
    ms = res["ms_per_frame"]
    print(f"offline: gen_videos {label} ({G.cfg.dtype}, num_ws {G.num_ws}, --image-mode {mode}), "
          f"{VIDEO_FRAMES} frames in chunks of {VIDEO_CHUNK}: {ms:.3f} ms a frame (CUDA events "
          f"around the chunk loop, host pull included), {1e3 / ms:.2f} frames/s, peak "
          f"{peak_gib:.3f} GiB, K1 launches {launches}; frame 0 vs G.synthesis max "
          f"{err} uint8 levels; K1 vs plain on the first chunk's inputs, bf16 ({VIDEO_CHUNK}, "
          f"4096, 96+96, 52), max abs err {k1_err:.3g}; wrote {os.path.basename(res['path'])} "
          f"({smi})", flush=True)
    return {"launches": launches, "ms_per_frame": ms, "fps": 1e3 / ms, "peak_gib": peak_gib,
            "frame0_err": err, "k1_err": k1_err}


def fp32_copy(G, device: str):
    """G's weights under its config with dtype float32, on `device`."""
    from dataclasses import replace

    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    G32 = Ide3dGenerator(replace(G.cfg, dtype="float32"))
    G32.load_state_dict(G.state_dict())
    return G32.to(device).eval()


def offline_shapes(snap: str, outdir: str, smi: str) -> dict:
    """apps.extract_shapes.main at 256^3 for seed 0 on the snapshot (timed),
    held against the same grid from an fp32 copy of its weights on the card
    (<= 3e-2 x max|sigma|: the bf16 vb stack against fp32); the fp32 copy's
    first 2^18-point chunk is held against the same chunk on the CPU
    (<= 3e-5 x scale)."""
    import os

    from ide3d_tpu_torch.apps import common, extract_shapes as es

    N, M = 256, 2**18
    secs = es.main(["--network", snap, "--seeds", "0", "--voxel-resolution", str(N),
                    "--outdir", outdir, "--device", "cuda"])["seconds_per_seed"][0]
    sig = np.load(os.path.join(outdir, "0.npy")).reshape(-1)
    if sig.size != N**3 or not np.isfinite(sig).all():
        raise RuntimeError(f"extract_shapes: sigma grid of {sig.size} points, finite "
                           f"{np.isfinite(sig).all()}")
    samples = 0.9 * es.create_samples(N, 0.3)
    G = common.load_generator(snap, "cpu")
    grids = {}
    for dev, pts in (("cuda", samples), ("cpu", samples[:M])):
        G32 = fp32_copy(G, dev)
        table = es.fp32_table(G32, es.seed_ws(G32, 0, 1.0, dev))
        grids[dev] = es.sigma_grid(G32.synthesis.renderer, table, pts, M).cpu().numpy()
        del G32, table
    _check_finite("extract_shapes fp32 sigma", [torch.as_tensor(g) for g in grids.values()])
    chunk_err = float(np.abs(grids["cuda"][:M] - grids["cpu"]).max())
    chunk_scale = max(1.0, float(np.abs(grids["cpu"]).max()))
    if chunk_err > 3e-5 * chunk_scale:
        raise RuntimeError(f"extract_shapes: fp32 sigma card vs cpu max abs err {chunk_err}, "
                           f"scale {chunk_scale}")
    bf16_err = float(np.abs(sig - grids["cuda"]).max())
    scale = max(1.0, float(np.abs(grids["cuda"]).max()))
    if bf16_err > 3e-2 * scale:
        raise RuntimeError(f"extract_shapes: bf16 sigma grid vs fp32 max abs err {bf16_err}, "
                           f"scale {scale}")
    print(f"offline: extract_shapes 256^3 sigma of seed 0 (chunks of 2^18 points from the fp32 "
          f"plane table, the snapshot's bf16 vb stack): {secs:.3f} s a seed; range "
          f"[{sig.min():.3f}, {sig.max():.3f}]; the whole grid vs an fp32 copy's on the card max "
          f"abs err {bf16_err:.3g} at scale {scale:.3g} (limit 3e-2 x scale); the fp32 copy's "
          f"first 2^18-point chunk, card vs cpu, max abs err {chunk_err:.3g} at scale "
          f"{chunk_scale:.3g} (limit 3e-5 x scale) ({smi})", flush=True)
    return {"s_per_seed": secs, "sigma_err": chunk_err, "bf16_sigma_err": bf16_err}


def offline_mesh(snap: str, outdir: str, smi: str) -> dict:
    """apps.render_mesh.main at 128^3 with an 8-frame orbit: K1 once a frame
    at S=64+64 (fp32 planes); one frame's K1 inputs through kernel and plain."""
    import os

    from ide3d_tpu_torch.apps import render_mesh
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer

    captured = []

    def capture(*args, **kw):
        if not captured:
            captured.append((args, kw))
        return ray_march.sort_integrate(*args, **kw)

    video = os.path.join(outdir, "orbit.mp4")
    renderer.sort_integrate = capture
    try:
        ray_march.sort_integrate.launches = 0
        res = render_mesh.main(["--network", snap, "--voxel-resolution", "128", "--video", video,
                                "--frames", str(MESH_FRAMES), "--outdir", outdir, "--device", "cuda"])
        launches = ray_march.sort_integrate.launches
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    if launches != MESH_FRAMES:
        raise RuntimeError(f"render_mesh: K1 launched {launches} times for {MESH_FRAMES} frames")
    for name in ("0.obj", "0.ply"):
        if not os.path.getsize(os.path.join(outdir, name)) > 0:
            raise RuntimeError(f"render_mesh: {name} is empty")
    if not res["faces"] > 0 or not os.path.getsize(res["video"]) > 0:
        raise RuntimeError(f"render_mesh: {res['faces']} faces, video {res['video']}")
    ((args, kw),) = captured
    if tuple(args[1].shape) != (1, 4096, 64, 52) or tuple(args[3].shape) != (1, 4096, 64, 52) \
            or args[1].dtype != torch.float32:
        raise RuntimeError(f"render_mesh: K1 took {args[1].dtype} {tuple(args[1].shape)} + "
                           f"{tuple(args[3].shape)}")
    with torch.inference_mode():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
    torch.cuda.synchronize()
    _check_finite("render_mesh K1", got)
    err = max_err(got, ref)
    if err > 1e-4:
        raise RuntimeError(f"render_mesh: K1 vs plain at S=64+64 fp32 max abs err {err} > 1e-4")
    ms = res["ms_per_frame"]
    print(f"offline: render_mesh 128^3, iso level {res['level']:.3f}, {res['verts']} verts, "
          f"{res['faces']} faces; {MESH_FRAMES}-frame orbit of shaded depth at 64+64 samples: "
          f"{ms:.3f} ms a frame (host clock, shading and depth pull included), K1 launches "
          f"{launches}, K1 vs plain at fp32 (1, 4096, 64+64, 52) max abs err {err:.3g} ({smi})",
          flush=True)
    return {"launches": launches, "ms_per_frame": ms, "k1_err": err}


def phase_offline(smi: str) -> dict:
    import os
    import tempfile

    from ide3d_tpu_torch.models.generator import GeneratorConfig

    with tempfile.TemporaryDirectory() as root:
        flagship, refc = os.path.join(root, "flagship"), os.path.join(root, "ref_compat")
        t0 = time.perf_counter()
        write_snapshot(flagship, GeneratorConfig(), seed=0)
        write_snapshot(refc, GeneratorConfig(vb_ref_compat=True, raw_head="slice"), seed=1)
        snap_s = time.perf_counter() - t0
        v_flag = offline_video(flagship, "image_seg", os.path.join(root, "flagship.mp4"), smi,
                               "flagship snapshot")
        v_refc = offline_video(refc, "image_depth", os.path.join(root, "ref_compat.mp4"), smi,
                               "reference-compat")
        fp32 = fp32_card_vs_cpu(GeneratorConfig(vb_ref_compat=True, raw_head="slice",
                                                dtype="float32"), 1, "reference-compat")
        print(f"offline: GeneratorConfig(vb_ref_compat=True, raw_head=slice, dtype=float32) batch "
              f"1, cuda (K1) vs cpu (plain): max abs err {fp32['err']} at output scale "
              f"{fp32['scale']} (limit 3e-5 x scale); two snapshots written in {snap_s:.1f} s "
              f"({smi})", flush=True)
        shapes = offline_shapes(flagship, os.path.join(root, "shapes"), smi)
        mesh = offline_mesh(flagship, os.path.join(root, "mesh"), smi)
    return {"video": {"flagship": v_flag, "ref_compat": v_refc}, "fp32": fp32, "shapes": shapes,
            "mesh": mesh}


def main() -> None:
    smi = phase_device()
    phase_build()
    k = phase_kernel(smi.splitlines()[0])
    phase_fp32()
    f, G = phase_frame()
    p = phase_painter(G, smi.splitlines()[0])
    del G
    tr = phase_train(smi.splitlines()[0])
    off = phase_offline(smi.splitlines()[0])
    main_path, b1 = k["timing"][3], k["timing"][1]  # the frame runs K1 at B=3
    kb = tr["k1_backward"]
    print(json.dumps({"kernels": [{
        "name": "sort_integrate",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "launches": f["launches"],
        "max_abs_err": max(k["max_abs_err"], f["frame_err"], off["mesh"]["k1_err"],
                           *(v["k1_err"] for v in off["video"].values())),
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
        "painter_launches": {"per_request": p["launches"], "per_round": p["per_round"]},
        "train_launches": sum(n[0] for n in tr["full"]["launches"]),
        "train_b4": {"ms": kb["fwd_ms_b4"], "bound_ms": kb["fwd_bound_ms_b4"]},
        "video_launches": {k: v["launches"] for k, v in off["video"].items()},
        "video_max_abs_err": {k: v["k1_err"] for k, v in off["video"].items()},
        "mesh_launches": off["mesh"]["launches"],
        "mesh_max_abs_err": off["mesh"]["k1_err"],
    }, {
        "name": "sort_integrate_backward",
        "route": "cuda",
        "source": "ide3d_tpu_torch/csrc/ray_march.cu",
        "replaces": "ide3d_tpu/ops/pallas/ray_march.py:121",
        "autodiff_of": "ide3d_tpu/render/integration.py:85",
        "launches": sum(n[1] for n in tr["full"]["launches"]),
        "max_abs_err": kb["max_abs_err"],
        "max_abs_err_is": "relative to max|grad|",
        "ms": kb["ms"],
        "plain_ms": kb["plain_ms"],
        "bound_ms": kb["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "bytes": kb["bytes"],
        "bound_share": kb["bound_share"],
        "fwd_bwd_ms": kb["fwd_bwd_ms"],
        "fwd_bwd_bound_ms": kb["fwd_bwd_bound_ms"],
        "train_step": {k: tr["full"][k] for k in ("median_ms", "r1_step_ms", "warm_r1_step_ms",
                                                  "peak_gib", "imgs_per_s")},
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
