"""TRAINING.md's product loop with the PyTorch port on one CUDA card: the
sphere-head dataset, the 40-kimg GAN run, its resume to 120 kimg with FID/KID,
the hybrid encoder and its evaluation, the Painter demo on the encoder's
inversion and on a run_pti pivot, and the bf16 batch gap of the trained G.

    python3 tools/torch_trained_workflow.py --out out/trained

Every stage runs the port's CLI a user would run (train_gan,
train_hybrid_encoder, run_pti, tools/torch_eval_trained_encoder.py,
tools/torch_painter_trained_demo.py) in a process of its own, with the
commands of TRAINING.md:21-27, 70-72, 200-235, and prints one JSON line with
its wall time. Snapshots stay under --root (a temporary directory); the
records (stats and metric JSONL, fakes grids, the eval JSON lines, the demo
PNGs, every stage's log) are copied to --out. Before the GAN run, K1 and its
backward are held to their plain versions on the inputs and cotangents of a
train step at the run's own shapes (small preset, batch 8, fp32).
The counts (--kimg, --kimg2, --enc-steps, ...) can be cut for a short run.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
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
IDENTITIES = 250  # x 4 views: TRAINING.md's set
GRID_KIMG = 5  # the 40-kimg run's fakes grids (TRAINING.md shows 15 kimg)
LEG_KIMG = 40  # kimg of each resume leg, each a --resume of the last
EVAL_N = 32  # views of the encoder's evaluation (TRAINING.md:200-203)
ITEM = "00000_2"  # the view the Painter demo and run_pti invert


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


def k1_at_run_shapes(out: str, data: str) -> dict:
    """One train step of the small preset at batch 8 on a batch of the dataset;
    the G phase's first K1 call keeps its inputs and, through hooks, the
    step's own cotangents; then K1 against plain (fp32 <= 1e-4) and its
    backward against autograd through plain (<= 1e-4 x max|grad|)."""
    import torch

    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.data.dataset import CameraLabeledDataset, batch_to_device, infinite_loader
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.render import renderer
    from ide3d_tpu_torch.train.gan import (GanTrainConfig, d_input_channels, init_gan_state,
                                           make_gan_train_step)

    B, cfg = 8, PRESETS["small"]
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

    renderer.sort_integrate = capture
    try:
        state.step = 1  # no R1 on this step
        step(state, batch, torch.Generator(device="cuda").manual_seed(0), 0.0)
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    torch.cuda.synchronize()
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
    scale = max(float(r.abs().max()) for r in rb)
    bwd = max(float((g - r).abs().max()) for g, r in zip(gb, rb)) / scale
    sorted_share = [float((z[:, :, 1:] >= z[:, :, :-1]).all(2).float().mean())
                    for z in (args[0], args[2])]
    rec = {"stage": "k1", "vals": [list(args[1].shape), list(args[3].shape)],
           "dtype": str(args[1].dtype), "fwd_max_abs_err": fwd, "bwd_err_of_max_grad": bwd,
           "rays_sorted_coarse_fine": sorted_share,
           "finite": bool(all(torch.isfinite(t).all() for t in (*got, *gb)))}
    log_line(out, rec)
    if fwd > 1e-4 or bwd > 1e-4 or not rec["finite"]:
        raise SystemExit(f"K1 at the run's shapes: {rec} (limits 1e-4, 1e-4 x max|grad|)")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="where the records go")
    ap.add_argument("--root", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--kimg", type=float, default=40)
    ap.add_argument("--kimg2", type=float, default=120)
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
    stages = set(args.stages.split(","))
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    root = args.root or tempfile.mkdtemp(prefix="ide3d_trained_")
    os.makedirs(root, exist_ok=True)
    data = os.path.join(root, "sphere_faces")
    gan1, gan2, enc = (os.path.join(root, d) for d in ("gan_small_run", "gan_small_run2", "enc"))
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
           if shutil.which("nvidia-smi") else "no nvidia-smi")
    log_line(out, {"stage": "device", "smi": smi})

    if "dataset" in stages:
        run(out, "dataset", ["tools/torch_make_synthetic_dataset.py", "--out", data,
                             "--identities", str(IDENTITIES), "--views", "4"], 600)
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
                                         "--metrics", "fid,kid", "--metric-items", "500",
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
