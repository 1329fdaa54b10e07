"""TRAINING.md's product loop with the PyTorch port on one CUDA card: the
sphere-head dataset, the 40-kimg GAN run, its resume to 120 kimg with FID/KID,
the hybrid encoder and its evaluation, the Painter demo on the encoder's
inversion and on a run_pti pivot, and the bf16 batch gap of the trained G;
or (`--run flagship`) TRAINING.md's flagship run B.

    python3 tools/torch_trained_workflow.py --out out/trained
    python3 tools/torch_trained_workflow.py --run flagship --out out/flagship

Every stage runs the port's CLI a user would run (train_gan,
train_hybrid_encoder, run_pti, tools/torch_eval_trained_encoder.py,
tools/torch_painter_trained_demo.py) in a process of its own, with the
commands of TRAINING.md:21-27, 70-72, 200-235, and prints one JSON line with
its wall time. Snapshots stay under --root (a temporary directory); the
records (stats and metric JSONL, fakes grids, the eval JSON lines, the demo
PNGs, every stage's log) are copied to --out. Before the GAN run, K1 and its
backward are held to their plain versions on the inputs and cotangents of a
train step at the run's own shapes (small preset, batch 8, fp32).

The flagship run (TRAINING.md:126-180): the 1,000-view set at 512², K1 at
that run's shapes (full preset, batch 4, bf16), train_gan --preset full
--resolution 512 --batch 4 to 12 kimg with pixel FID on 500 items every 4
kimg and grids every 2, its --resume to 20 kimg into the same run directory
(the resumed ada_p checked against leg 1's last), the best-FID snapshot, a
readout of the fault checks (non-finite stats, logits, grid std, best FID)
and the bf16 batch gap on the card and the CPU. Two stages run only when
named in --stages: `dtype` runs the first 4.1 kimg of the run in bf16 and in
fp32, and `devices` one fp32 step of a snapshot (--network, else the bf16
leg's at 4 kimg) on the card and on the CPU (snapshot_step). The records go
to --out as torch_flagship_runB_*.jsonl and
img/torch_flagship_runB_fakes_<k>kimg.png.
The counts (--identities, --kimg, --kimg2, --metric-items, --enc-steps, ...)
can be cut for a short run.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

STAGES = ("dataset", "k1", "gan", "resume", "encoder", "eval", "painter", "pti", "gap")
FLAGSHIP_STAGES = ("dataset", "k1", "gan", "resume", "gap")  # "dtype", "devices" by name
GRID_KIMG = 5  # the 40-kimg run's fakes grids (TRAINING.md shows 15 kimg)
LEG_KIMG = 40  # kimg of each resume leg, each a --resume of the last
EVAL_N = 32  # views of the encoder's evaluation (TRAINING.md:200-203)
ITEM = "00000_2"  # the view the Painter demo and run_pti invert
# K1's limits by value dtype (PERF.md §2): forward max abs err, backward err / max|grad|
K1_LIMITS = {"torch.float32": (1e-4, 1e-4), "torch.bfloat16": (1e-3, 1e-2)}
RUN_B = {"kimg": 12, "kimg2": 20, "batch": 4, "ada_speed": 100}  # TRAINING.md:155-180
RUN_B_GRIDS = (4, 14, 18)  # the grids of run B's readout (TRAINING.md:165, 174)
GRID_MAX_BYTES = 1 << 20
ADA_INTERVAL = 4  # train_gan's controller: one update every 4 steps
DTYPE_KIMG = 4.1  # the dtype stage's legs: to the 4-kimg grid (train_gan's fall 4 images past)
STEP_TOL = 1e-4  # a snapshot's fp32 step, card against CPU (as chip_smoke's tiny step)


def log_line(out: str, rec: dict) -> None:
    print(json.dumps(rec), flush=True)
    with open(os.path.join(out, "workflow.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def keep(src: str, dst: str) -> None:
    """Copy a record into --out, where the run wrote it (a short run may not)."""
    if os.path.exists(src):
        shutil.copy(src, dst)


def run(out: str, name: str, argv: list, timeout: float) -> str:
    """One CLI in a process of its own; its output goes to <out>/<name>.log and
    a JSON line with the wall time is printed. Raises if it fails."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable] + argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, name + ".log"), "w") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    log_line(out, {"stage": name, "rc": p.returncode, "wall_s": wall, "argv": argv})
    if p.returncode:
        sys.stderr.write(p.stderr[-4000:])
        raise SystemExit(f"{name} failed (rc {p.returncode})")
    return p.stdout


def k1_at_run_shapes(out: str, data: str, preset: str = "small", batch: int = 8) -> dict:
    """One train step of the preset at its batch on a batch of the dataset; the
    G phase's first K1 call keeps its inputs and, through hooks, the step's own
    cotangents; then K1 against plain and its backward against autograd
    through plain, at the limits of the values' dtype (k1_verdict). The record
    also holds the step's K1 launches (forward, backward, double backward) and
    how many rays of each half reach K1 unsorted."""
    import torch

    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.data.dataset import CameraLabeledDataset, batch_to_device, infinite_loader
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.train.gan import (GanTrainConfig, d_input_channels, init_gan_state,
                                           make_gan_train_step)

    B, cfg = batch, PRESETS[preset]
    tcfg = GanTrainConfig(r1_gamma=0.0002 * cfg.img_resolution ** 2 / B)
    G = Ide3dGenerator(cfg).init(0).cuda()
    D = Discriminator(DiscriminatorConfig(img_resolution=cfg.img_resolution,
                                          img_channels=d_input_channels(tcfg, cfg))).init(1).cuda()
    state = init_gan_state(G, D, tcfg)
    step = make_gan_train_step(tcfg)
    ds = CameraLabeledDataset(os.path.join(data, "img"), os.path.join(data, "seg"),
                              resolution=cfg.img_resolution, xflip=True)
    batch = batch_to_device(next(infinite_loader(ds, B, seed=0)), "cuda")
    captured = {}

    def capture(*args, **kw):
        res = ray_march.sort_integrate(*args, **kw)
        if not captured and args[1].requires_grad:
            captured.update(args=tuple(a.detach() for a in args), kw=kw, cot=[None] * 3)
            for i, t in enumerate(res):
                if t.requires_grad:
                    t.register_hook(lambda g, i=i: captured["cot"].__setitem__(
                        i, None if g is None else g.detach()))
        return res

    counters = (ray_march.sort_integrate, ray_march.sort_integrate_backward,
                ray_march.sort_integrate_double_backward)
    for fn in counters:
        fn.launches = 0
    renderer.sort_integrate = capture
    try:
        state.step = 1  # no R1 on this step
        step(state, batch, torch.Generator(device="cuda").manual_seed(0), 0.0)
        torch.cuda.synchronize()
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    launches = [fn.launches for fn in counters]
    del state, step, G, D, batch
    args, kw = captured["args"], captured["kw"]
    bsz, rays, _, c1 = args[1].shape
    cot = [torch.zeros(bsz, rays, n, device="cuda") if g is None else g.float().contiguous()
           for g, n in zip(captured["cot"], (c1 - 1, 1, 1))]
    with torch.no_grad():
        got, ref = ray_march.sort_integrate(*args, **kw), ray_march.sort_integrate_plain(*args, **kw)
        gb = ray_march.sort_integrate_backward(*args, *cot, **kw)
        rb = ray_march.sort_integrate_backward_plain(*args, *cot, **kw)
    torch.cuda.synchronize()
    fwd = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.float().abs().max()) for r in rb)
    bwd = max(float((g.float() - r.float()).abs().max()) for g, r in zip(gb, rb)) / scale
    ordered = [(z[:, :, 1:] >= z[:, :, :-1]).all(2) for z in (args[0], args[2])]
    rec = {"stage": "k1", "preset": preset, "batch": B, "vals": [list(args[1].shape),
                                                                 list(args[3].shape)],
           "dtype": str(args[1].dtype), "fwd_max_abs_err": fwd, "bwd_err_of_max_grad": bwd,
           "limits": list(K1_LIMITS[str(args[1].dtype)]), "step_launches": launches,
           "rays_sorted_coarse_fine": [float(o.float().mean()) for o in ordered],
           "rays_unsorted_coarse_fine": [int((~o).sum()) for o in ordered],
           "finite": bool(all(torch.isfinite(t).all() for t in (*got, *gb)))}
    del args, captured, got, ref, gb, rb, cot
    torch.cuda.empty_cache()
    log_line(out, rec)
    return k1_verdict(rec)


def k1_verdict(rec: dict) -> dict:
    """The k1 record, or SystemExit naming the limits applied: those of its
    values' dtype (K1_LIMITS)."""
    fwd_lim, bwd_lim = K1_LIMITS[rec["dtype"]]
    if (rec["fwd_max_abs_err"] > fwd_lim or rec["bwd_err_of_max_grad"] > bwd_lim
            or not rec["finite"]):
        raise SystemExit(f"K1 at the run's shapes: {rec} (limits at {rec['dtype']}: forward "
                         f"{fwd_lim:g}, backward {bwd_lim:g} x max|grad|)")
    return rec


def batch_gap(out: str, network: str, device: str) -> list:
    """The trained G's bf16 batch gap: one latent alone and as row 0 of a batch
    of 2, frontal camera, in bf16 (the snapshot cast) and fp32 (TF32 off)."""
    import torch

    from bf16_batch_gap import gap_stats
    from ide3d_tpu_torch.apps.common import load_generator
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    trained = load_generator(network, "cpu")
    rows = []
    for dtype in ("bfloat16", "float32"):
        G = Ide3dGenerator(dataclasses.replace(trained.cfg, dtype=dtype))
        G.load_state_dict(trained.state_dict())
        G = G.to(device).eval()
        z = torch.as_tensor(np.random.RandomState(0).randn(2, G.cfg.z_dim), dtype=torch.float32,
                            device=device)
        c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None].expand(2, -1)
        with torch.inference_mode():
            ws = G.mapping(z, c)
            one, two = (G.synthesis(w, cc)[0].float().cpu().numpy()
                        for w, cc in ((ws[:1], c[:1]), (ws, c)))
        rows.append({"stage": "gap", "network": network, "device": device, "dtype": dtype,
                     **gap_stats(one, two)})
        log_line(out, rows[-1])
    return rows


def snapshot_step(out: str, network: str, data: str, devices: tuple) -> dict:
    """One train step of a run-B snapshot (train_gan's step function at the
    snapshot's ada_p, R1 on, as every 16th step) on each device in fp32 with
    TF32 off, from the same weights, batch and draws: every draw is made on
    one CPU generator and moved to the step's device. The stats and the
    gradients that reach Adam (G's; D's with R1's) of the first device against
    the second's, as max abs err / max(1, |stat|) and / max|grad| a network,
    at STEP_TOL."""
    import torch

    from ide3d_tpu_torch.data.dataset import CameraLabeledDataset, batch_to_device, infinite_loader
    from ide3d_tpu_torch.io.checkpoint import config_from_jsonable, load_checkpoint
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.parallel import mesh
    from ide3d_tpu_torch.train import augment, gan

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    saved, meta = load_checkpoint(network)
    gcfg = dataclasses.replace(config_from_jsonable(meta["config"]), dtype="float32")
    B, ada_p = RUN_B["batch"], float(meta["ada_p"])
    tcfg = gan.GanTrainConfig(r1_gamma=0.0002 * gcfg.img_resolution ** 2 / B,
                              aug=augment.AugmentConfig(compute_dtype="float32"))
    host = next(infinite_loader(CameraLabeledDataset(
        os.path.join(data, "img"), os.path.join(data, "seg"), resolution=gcfg.img_resolution,
        xflip=True), B, seed=0))
    step_no = -(-int(meta["step"]) // tcfg.r1_interval) * tcfg.r1_interval
    draw, apply = mesh.draw, gan._apply_grads
    users = [m for n, m in sys.modules.items()
             if n.startswith("ide3d_tpu_torch.") and getattr(m, "draw", None) is draw]
    res = {}
    try:
        for dev in devices:
            cpu_gen, grads = torch.Generator().manual_seed(0), {}

            def shared(fn, shape, generator=None, device=None, **kw):
                return draw(fn, shape, generator=cpu_gen, **kw).to(device)

            def keep_grads(params, gs, opt, group):
                grads[id(opt)] = [g.detach().float().cpu() for g in gs if g is not None]
                apply(params, gs, opt, group)

            for m in users:
                m.draw = shared
            gan._apply_grads = keep_grads
            G = Ide3dGenerator(gcfg)
            G.load_state_dict(saved["G"])
            D = Discriminator(DiscriminatorConfig(img_resolution=gcfg.img_resolution,
                                                  img_channels=gan.d_input_channels(tcfg, gcfg),
                                                  dtype="float32"))
            D.load_state_dict(saved["D"])
            state = gan.init_gan_state(G.to(dev), D.to(dev), tcfg)
            state.step = step_no
            t0 = time.perf_counter()
            _, stats = gan.make_gan_train_step(tcfg)(
                state, batch_to_device(host, dev), torch.Generator(device=dev).manual_seed(0), ada_p)
            stats = {k: float(v) for k, v in stats.items()}
            res[dev] = {"stats": stats, "wall_s": time.perf_counter() - t0,
                        "grads": {"G": grads[id(state.opt_g)], "D": grads[id(state.opt_d)]}}
            del G, D, state, grads
    finally:
        for m in users:
            m.draw = draw
        gan._apply_grads = apply
    got, ref = (res[d] for d in devices)
    stat_err = {k: abs(got["stats"][k] - v) / max(1.0, abs(v)) for k, v in ref["stats"].items()}
    grad_err = {k: max(float((a - b).abs().max()) for a, b in zip(got["grads"][k], v))
                / max(float(b.abs().max()) for b in v) for k, v in ref["grads"].items()}
    rec = {"stage": "devices", "network": network, "devices": list(devices), "step": step_no,
           "ada_p": ada_p, "stats": {d: res[d]["stats"] for d in devices},
           "wall_s": {d: res[d]["wall_s"] for d in devices}, "stat_err": stat_err,
           "grad_err": grad_err, "limit": STEP_TOL,
           "finite": bool(all(np.isfinite(v) for d in devices for v in res[d]["stats"].values())
                          and all(torch.isfinite(g).all() for d in devices
                                  for v in res[d]["grads"].values() for g in v))}
    log_line(out, rec)
    if not rec["finite"] or max(*stat_err.values(), *grad_err.values()) > STEP_TOL:
        raise SystemExit(f"the snapshot's step, {devices[0]} against {devices[1]}: stats "
                         f"{stat_err}, gradients {grad_err} (limit {STEP_TOL:g})")
    return rec


def best_snapshot(run_dir: str) -> tuple:
    """(snapshot dir, kimg, fid) of the lowest FID in metric-fid.jsonl."""
    with open(os.path.join(run_dir, "metric-fid.jsonl")) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    best = min(recs, key=lambda r: r["results"]["fid"])
    kimg = best["kimg"]
    snap = os.path.join(run_dir, f"snapshot-{int(round(kimg)):06d}")
    if not os.path.isdir(snap):
        snap = os.path.join(run_dir, "snapshot-final")
    return snap, kimg, best


def read_jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def flagship_gan_argv(data: str, run_dir: str, kimg: float, device: str,
                      metric_items: int = 500, resume: str = None) -> list:
    """train_gan's argv for a leg of TRAINING.md's run B: the full preset at
    512², batch 4, snapshots and pixel FID every 4 kimg, grids every 2, ADA
    speed 100; no --r1-gamma, so the CLI takes 0.0002·512²/4 = 13.1, and PL
    off (--pl-weight 0, the default)."""
    argv = ["-m", "ide3d_tpu_torch.apps.train_gan", "--data", os.path.join(data, "img"),
            "--seg", os.path.join(data, "seg"), "--outdir", run_dir, "--preset", "full",
            "--resolution", "512", "--batch", str(RUN_B["batch"]), "--kimg", f"{kimg:g}",
            "--snap-kimg", "4", "--grid-kimg", "2", "--metrics", "fid",
            "--metric-items", str(metric_items), "--ada-speed", f"{RUN_B['ada_speed']:g}",
            "--device", device]
    return argv + (["--resume", resume] if resume else [])


def check_r1_gamma(name: str, stdout: str) -> None:
    want = f"r1-gamma (auto): {0.0002 * 512 ** 2 / RUN_B['batch']:.3g}"
    if want not in stdout:
        raise SystemExit(f"{name}: the log does not say {want!r}")


def check_finite(name: str, rows: list) -> None:
    bad = [r for r in rows if not all(np.isfinite(v) for v in r.values()
                                      if isinstance(v, (int, float)))]
    if bad:
        raise SystemExit(f"{name}: {len(bad)} stats rows hold a NaN or inf, the first {bad[0]}")


def resume_check(before: list, after: list, fid_before: list, fid_after: list,
                 stdout: str) -> dict:
    """Leg 2 appended to leg 1's stats and FID lines, and resumed at leg 1's
    last ada_p within one controller update."""
    n = len(before)
    added = after[n:]
    if after[:n] != before or not added or (before and added[0]["kimg"] <= before[-1]["kimg"]):
        raise SystemExit(f"resume: the stats rows were not appended ({n} rows, then {len(after)})")
    if fid_after[:len(fid_before)] != fid_before or len(fid_after) <= len(fid_before):
        raise SystemExit("resume: the FID lines were not appended")
    m = re.search(r"^resumed \S+: step (\d+), ada_p (\S+)$", stdout, re.M)
    if not m:
        raise SystemExit("resume: the log names no resumed step and ada_p")
    update = RUN_B["batch"] * ADA_INTERVAL / (RUN_B["ada_speed"] * 1000)
    p0, last = float(m.group(2)), before[-1]["ada_p"] if before else 0.0
    if abs(p0 - last) > update:
        raise SystemExit(f"resume: ada_p {p0} against leg 1's last {last} (one update {update})")
    return {"stage": "resume_check", "rows": [n, len(added)],
            "fid_kimg": [r["kimg"] for r in fid_after], "resumed_step": int(m.group(1)),
            "resumed_ada_p": p0, "leg1_last": {k: before[-1][k] for k in ("kimg", "ada_p")},
            "leg2_first": {k: added[0][k] for k in ("kimg", "ada_p")}, "one_update": update}


def readout(run_dir: str, rows_leg1: int) -> dict:
    """The run's numbers beside the faults of TRAINING.md's run B: non-finite
    stats, a logit past run A's ±448, a mean-colour collapse (the grids' std
    per channel under 5 at 2-4 kimg; compare_sphere_runs.grid_std), a best
    FID above 1.5 x JAX's 87.9 (the last two only for a run of run B's length)."""
    from compare_sphere_runs import grid_std

    rows = read_jsonl(os.path.join(run_dir, "stats.jsonl"))
    fids = read_jsonl(os.path.join(run_dir, "metric-fid.jsonl"))
    top = max(rows, key=lambda r: max(abs(r["real_logits"]), abs(r["fake_logits"])))
    max_logit = max(abs(top["real_logits"]), abs(top["fake_logits"]))
    stds = {}
    for png in sorted(glob.glob(os.path.join(run_dir, "fakes[0-9]*[0-9].png"))):
        stds[int(os.path.basename(png)[5:11])] = grid_std(png)
    rates = []  # imgs/s between consecutive rows of one leg (the loop, grids and snapshots)
    for leg in (rows[:rows_leg1], rows[rows_leg1:]):
        for a, b in zip(leg, leg[1:]):
            rates.append((b["kimg"] - a["kimg"]) * 1000 / ((b["time_h"] - a["time_h"]) * 3600))
    best = min(fids, key=lambda r: r["results"]["fid"]) if fids else None
    faults = []
    try:
        check_finite("stats", rows)
    except SystemExit as e:
        faults.append(str(e))
    if max_logit > 448:
        faults.append(f"|logit| {max_logit} at {top['kimg']} kimg")
    if rows and rows[-1]["kimg"] >= RUN_B["kimg2"]:
        faults += [f"channel std {v[1]} at {k} kimg (grid std {v[0]})" for k, v in stds.items()
                   if 2 <= k <= 4 and v[1] < 5]
        if best and best["results"]["fid"] > 1.5 * 87.9:
            faults.append(f"best FID {best['results']['fid']}")
    return {"stage": "readout", "rows": len(rows), "max_abs_logit": max_logit,
            "max_abs_logit_kimg": top["kimg"], "grid_std": stds,
            "fid": {r["kimg"]: r["results"]["fid"] for r in fids},
            "best": best and {"kimg": best["kimg"], "fid": best["results"]["fid"]},
            "imgs_per_s": rates and {"median": float(np.median(rates)), "min": min(rates),
                                     "max": max(rates)}, "faults": faults}


def keep_grid(src: str, dst: str) -> None:
    """Copy a grid, halving its size until the PNG is under 1 MB."""
    import PIL.Image

    if not os.path.exists(src):
        return
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copy(src, dst)
    img = PIL.Image.open(src).convert("RGB")
    while os.path.getsize(dst) > GRID_MAX_BYTES:
        img = img.reduce(2)
        img.save(dst)


def flagship(args, out: str, root: str, t_start: float) -> int:
    """TRAINING.md's run B (see the module's docstring)."""
    stages = set((args.stages or ",".join(FLAGSHIP_STAGES)).split(","))
    kimg, kimg2 = args.kimg or RUN_B["kimg"], args.kimg2 or RUN_B["kimg2"]
    data, run_dir = os.path.join(root, "sphere_faces_512"), os.path.join(root, "flagship_runB")
    stats_path, fid_path = (os.path.join(run_dir, n) for n in ("stats.jsonl", "metric-fid.jsonl"))
    if "dataset" in stages:
        run(out, "dataset", ["tools/torch_make_synthetic_dataset.py", "--out", data, "--identities",
                             str(args.identities), "--views", "4", "--resolution", "512"], 1800)
    if "k1" in stages:
        k1_at_run_shapes(out, data, "full", RUN_B["batch"])
    if "gan" in stages:
        stdout = run(out, "gan", flagship_gan_argv(data, run_dir, kimg, args.device,
                                                   args.metric_items), 3500)
        check_r1_gamma("gan", stdout)
        check_finite("gan", read_jsonl(stats_path))
    network = os.path.join(run_dir, "snapshot-final")
    if "resume" in stages:
        before, fid_before = read_jsonl(stats_path), read_jsonl(fid_path)
        stdout = run(out, "resume", flagship_gan_argv(data, run_dir, kimg2, args.device,
                                                      args.metric_items, resume=network), 3500)
        check_r1_gamma("resume", stdout)
        check_finite("resume", read_jsonl(stats_path))
        log_line(out, resume_check(before, read_jsonl(stats_path), fid_before,
                                   read_jsonl(fid_path), stdout))
        network, best_kimg, rec = best_snapshot(run_dir)
        log_line(out, {"stage": "best", "network": network, "kimg": best_kimg, "fid": rec})
        keep(stats_path, os.path.join(out, "torch_flagship_runB_stats.jsonl"))
        keep(fid_path, os.path.join(out, "torch_flagship_runB_metric_fid.jsonl"))
        for k in sorted({*RUN_B_GRIDS, int(round(best_kimg))}):
            keep_grid(os.path.join(run_dir, f"fakes{k:06d}.png"),
                      os.path.join(out, "img", f"torch_flagship_runB_fakes_{k}kimg.png"))
        log_line(out, readout(run_dir, len(before)))
    if "dtype" in stages:
        for dtype in ("bfloat16", "float32"):
            dtype_leg(out, data, os.path.join(root, f"leg_{dtype}"), dtype, args)
    if "devices" in stages:
        snapshot_step(out, args.network or os.path.join(root, "leg_bfloat16", "snapshot-000004"),
                      data, (args.device, "cpu"))
    if "gap" in stages:
        for device in dict.fromkeys((args.device, "cpu")):
            batch_gap(out, network, device)
    log_line(out, {"stage": "done", "wall_s": time.perf_counter() - t_start})
    return 0


def dtype_leg(out: str, data: str, run_dir: str, dtype: str, args) -> dict:
    """Run B's first DTYPE_KIMG from scratch with G, D and ADA computing in
    `dtype` (tools/torch_train_gan_dtype.py, which checks the dtypes it
    built): a bf16 leg beside an fp32 one tells a bf16 drift from a fault of
    the training itself."""
    from compare_sphere_runs import grid_std

    argv = flagship_gan_argv(data, run_dir, DTYPE_KIMG, args.device, args.metric_items)
    t0 = time.perf_counter()
    stdout = run(out, f"dtype_{dtype}",
                 ["tools/torch_train_gan_dtype.py", "--dtype", dtype, *argv[2:]], 3500)
    built = json.loads(stdout.strip().splitlines()[-1])  # the tool exits 1 on another dtype
    rows = read_jsonl(os.path.join(run_dir, "stats.jsonl"))
    check_finite(f"dtype_{dtype}", rows)
    rec = {"stage": "dtype", "dtype": dtype, "kimg": DTYPE_KIMG, **built,
           "wall_s": time.perf_counter() - t0, "rows": rows,
           "fid": {r["kimg"]: r["results"]["fid"]
                   for r in read_jsonl(os.path.join(run_dir, "metric-fid.jsonl"))},
           "grid_std": {}}
    for png in sorted(glob.glob(os.path.join(run_dir, "fakes[0-9]*[0-9].png"))):
        k = int(os.path.basename(png)[5:11])
        rec["grid_std"][k] = grid_std(png)
        keep_grid(png, os.path.join(out, "img", f"dtype_{dtype}_fakes_{k}kimg.png"))
    log_line(out, rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="where the records go")
    ap.add_argument("--root", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--run", choices=["sphere", "flagship"], default="sphere",
                    help="TRAINING.md's sphere-head loop or its flagship run B")
    ap.add_argument("--stages", default=None,
                    help=f"default: {','.join(STAGES)} (sphere), {','.join(FLAGSHIP_STAGES)} "
                         "(flagship)")
    ap.add_argument("--identities", type=int, default=250, help="x 4 views: TRAINING.md's set")
    ap.add_argument("--kimg", type=float, default=None, help="default 40 (sphere), 12 (flagship)")
    ap.add_argument("--kimg2", type=float, default=None,
                    help="the resume's end: default 120 (sphere), 20 (flagship)")
    ap.add_argument("--metric-items", type=int, default=500)
    ap.add_argument("--enc-steps", default="6000,24000",
                    help="encoder checkpoints to reach and evaluate, each resumed from the last")
    ap.add_argument("--projector-steps", type=int, default=450)
    ap.add_argument("--pti-steps", type=int, default=350)
    ap.add_argument("--network", default=None,
                    help="a G snapshot for the encoder and tool stages in place of the runs'")
    ap.add_argument("--export-g", action="store_true",
                    help="write the chosen G's G_ema alone to <out>/best_g")
    ap.add_argument("--device", default="cuda",
                    help="the CLIs' and the gap stage's device; the k1 stage needs the card")
    ap.add_argument("--budget-s", type=float, default=3300,
                    help="the encoder's later legs are skipped when the time left is short")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    root = os.path.abspath(args.root or tempfile.mkdtemp(prefix="ide3d_trained_"))
    os.makedirs(root, exist_ok=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
           if shutil.which("nvidia-smi") else "no nvidia-smi")
    log_line(out, {"stage": "device", "smi": smi})
    if args.run == "flagship":
        return flagship(args, out, root, t_start)

    stages = set((args.stages or ",".join(STAGES)).split(","))
    args.kimg, args.kimg2 = args.kimg or 40, args.kimg2 or 120
    data = os.path.join(root, "sphere_faces")
    gan1, gan2, enc = (os.path.join(root, d) for d in ("gan_small_run", "gan_small_run2", "enc"))

    if "dataset" in stages:
        run(out, "dataset", ["tools/torch_make_synthetic_dataset.py", "--out", data,
                             "--identities", str(args.identities), "--views", "4"], 600)
    if "k1" in stages:
        k1_at_run_shapes(out, data)

    gan_args = ["--data", os.path.join(data, "img"), "--seg", os.path.join(data, "seg"),
                "--batch", "8", "--resolution", "64", "--preset", "small", "--device", args.device]
    if "gan" in stages:
        run(out, "gan", ["-m", "ide3d_tpu_torch.apps.train_gan", *gan_args, "--outdir", gan1,
                         "--kimg", str(args.kimg), "--grid-kimg", str(GRID_KIMG)], 3500)
        keep(os.path.join(gan1, "stats.jsonl"), os.path.join(out, "sphere_run_stats.jsonl"))
        for png in glob.glob(os.path.join(gan1, "fakes*.png")):
            keep(png, os.path.join(out, "run1_" + os.path.basename(png)))
    network = args.network or os.path.join(gan1, "snapshot-final")
    if "gan" in stages:
        s_per_kimg = json.loads(open(os.path.join(out, "workflow.jsonl")).read().splitlines()[-1])[
            "wall_s"] / args.kimg
    else:
        s_per_kimg = 0.0
    if "resume" in stages:
        # --kimg -> --kimg2 in legs, each a --resume of the last leg's
        # snapshot-final into one run directory (stats and metrics append).
        cur = args.kimg
        while cur < args.kimg2:
            nxt = min(cur + LEG_KIMG, args.kimg2)
            left = args.budget_s - (time.perf_counter() - t_start)
            if s_per_kimg * (nxt - cur) * 1.15 > left:
                log_line(out, {"stage": "resume", "cut_at_kimg": cur, "time_left_s": left})
                break
            run(out, f"resume_{nxt:g}", ["-m", "ide3d_tpu_torch.apps.train_gan", *gan_args,
                                         "--outdir", gan2, "--resume", network, "--kimg", str(nxt),
                                         "--metrics", "fid,kid",
                                         "--metric-items", str(args.metric_items),
                                         "--snap-kimg", "20", "--ada-speed", "100",
                                         "--grid-kimg", "20"], 3500)
            network, cur = os.path.join(gan2, "snapshot-final"), nxt
        for name in ("stats.jsonl", "metric-fid.jsonl", "metric-kid.jsonl"):
            keep(os.path.join(gan2, name), os.path.join(out, "sphere_run2_" + name))
        for png in glob.glob(os.path.join(gan2, "fakes*.png")):
            keep(png, os.path.join(out, "run2_" + os.path.basename(png)))
        network, kimg, rec = best_snapshot(gan2)
        log_line(out, {"stage": "best", "network": network, "kimg": kimg, "fid": rec})
    if args.export_g:
        # G_ema alone (the snapshots hold D and both Adam states too), for a later call.
        from ide3d_tpu_torch.io.checkpoint import config_from_jsonable, load_checkpoint, save_checkpoint

        state, meta = load_checkpoint(network)
        save_checkpoint(os.path.join(out, "best_g"), {"G_ema": state["G_ema"]},
                        config=config_from_jsonable(meta["config"]), step=meta.get("step"),
                        source=network)
        log_line(out, {"stage": "export_g", "network": network, "step": meta.get("step")})

    enc_ckpt, done_steps, s_per_step = None, 0, 0.0
    for steps in (int(s) for s in args.enc_steps.split(",")):
        if "encoder" not in stages:
            break
        # a later leg runs only when it and the tool stages after it fit the budget
        left = args.budget_s - (time.perf_counter() - t_start)
        if enc_ckpt and s_per_step * (steps - done_steps) * 1.2 + 600 > left:
            log_line(out, {"stage": "encoder", "skipped_leg": steps, "time_left_s": left})
            break
        t_leg = time.perf_counter()
        run(out, f"encoder_{steps}",
            ["-m", "ide3d_tpu_torch.apps.train_hybrid_encoder", "--network", network,
             "--data", os.path.join(data, "img"), "--seg", os.path.join(data, "seg"),
             "--outdir", enc, "--batch", "8", "--max-steps", str(steps), "--snap", str(steps),
             "--device", args.device]
            + (["--resume", enc_ckpt] if enc_ckpt else []), 3500)
        s_per_step = (time.perf_counter() - t_leg) / (steps - done_steps)
        enc_ckpt, done_steps = os.path.join(enc, f"encoder-{steps:08d}"), steps
        keep(os.path.join(enc, "stats.jsonl"), os.path.join(out, "encoder_stats.jsonl"))
        if "eval" in stages:
            res = run(out, f"eval_{steps}", ["tools/torch_eval_trained_encoder.py", "--network",
                                             network, "--encoder", enc_ckpt, "--data", data,
                                             "--n", str(EVAL_N), "--device", args.device], 600)
            log_line(out, {"stage": "eval", "steps": steps, **json.loads(res.strip().splitlines()[-1])})

    img_out = os.path.join(out, "img")
    if "painter" in stages and enc_ckpt:
        run(out, "painter", ["tools/torch_painter_trained_demo.py", "--network", network,
                             "--encoder", enc_ckpt, "--data", data, "--item", ITEM,
                             "--outdir", img_out, "--device", args.device], 600)
    if "pti" in stages and enc_ckpt:
        pti = os.path.join(root, "pti")
        with open(os.path.join(data, "img", "dataset.json")) as f:
            labels = dict(json.load(f)["labels"])
        with open(os.path.join(root, "labels.json"), "w") as f:
            json.dump(labels, f)
        run(out, "run_pti", ["-m", "ide3d_tpu_torch.apps.run_pti", "--network", network,
                             "--images", os.path.join(data, "img", ITEM + ".png"),
                             "--masks", os.path.join(data, "seg"), "--encoder", enc_ckpt,
                             "--labels", os.path.join(root, "labels.json"), "--opencv-labels",
                             "--projector-steps", str(args.projector_steps),
                             "--pti-steps", str(args.pti_steps), "--lpips-threshold", "2e-4",
                             "--outdir", pti, "--device", args.device], 1800)
        for png in glob.glob(os.path.join(pti, "*.png")):
            keep(png, os.path.join(out, "pti_" + os.path.basename(png)))
        run(out, "painter_pti", ["tools/torch_painter_trained_demo.py", "--network",
                                 os.path.join(pti, f"model_{ITEM}"), "--encoder", enc_ckpt,
                                 "--data", data, "--item", ITEM, "--outdir", img_out,
                                 "--pivot", os.path.join(pti, ITEM + ".npz"),
                                 "--prefix", "painter_pti", "--device", args.device], 600)
    if "gap" in stages:
        batch_gap(out, network, args.device)
    log_line(out, {"stage": "done", "wall_s": time.perf_counter() - t_start})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
