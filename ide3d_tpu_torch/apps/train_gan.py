"""IDE-3D GAN training loop, in PyTorch (counterpart of ide3d_tpu/apps/train_gan.py).

Usage:
    python -m ide3d_tpu_torch.apps.train_gan --data imgs/ --seg segs/ --outdir runs/g0 \\
        --batch 4 --kimg 25000 [--resume runs/g0/snapshot-000200] [--device cuda]

A data-parallel StyleGAN2-ADA loop (the cards unless `--device cpu`): one
rank per card over NCCL (gloo on the CPU), as many as are visible (torchrun's
world when it launched the process: `torchrun --nproc_per_node N -m
ide3d_tpu_torch.apps.train_gan ...`), reduced to the largest world that
divides --batch, as the JAX app's mesh; the ranks beyond it leave and exit 0.
Each rank reads its rows of the global batch (the compact uint8 loader, copied
to its card from pinned memory on a side stream, parallel/mesh.prefetch_to_device)
and runs the G-first train step with lazy R1 (train/gan.py) with averaged
gradients; the ADA p-controller is fed from the steps' sign statistics,
averaged over the ranks and read back every 4 steps. Rank 0 writes the G_ema
sample grids, the snapshots (io/checkpoint.py), the interval means of the
global batch to stats.jsonl and the metrics; at every snapshot the ranks'
G, D and G_ema are checked equal bit for bit. `--resume` (read by rank 0 and
broadcast) restores G, D, G_ema, both optimizers, pl_mean, the step and
ada_p. `--metrics fid,kid` evaluates G_ema at every snapshot and at the end
(once per kimg point) on the un-mirrored dataset, split over the ranks,
appending {"kimg", ...record} to metric-<name>.jsonl. `--pl-weight` turns on
path-length regularization (every 4 steps) and `--wavelet-aa` the sym6
anti-aliased ADA warp. `main` returns rank 0's training state (None where it
started the ranks or left the group).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--seg", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--kimg", type=float, default=25000)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--snap-kimg", type=int, default=200)
    ap.add_argument("--grid-kimg", type=int, default=50)
    ap.add_argument("--ada-target", type=float, default=0.6)
    ap.add_argument("--ada-speed", type=float, default=500.0,
                    help="ADA adjustment speed in kimg (lower = faster p adaptation)")
    ap.add_argument("--ada-pmax", type=float, default=1.0, help="cap on ADA p")
    ap.add_argument("--no-ada", action="store_true")
    ap.add_argument("--fixed-ada-p", type=float, default=None,
                    help="hold ADA at this constant p instead of running the controller")
    ap.add_argument("--wavelet-aa", action="store_true",
                    help="sym6 wavelet anti-aliasing around the ADA warp (~4x its cost)")
    ap.add_argument("--r1-gamma", type=float, default=None,
                    help="R1 weight; default the StyleGAN2-ADA heuristic 0.0002*resolution^2/batch")
    ap.add_argument("--pl-weight", type=float, default=0.0,
                    help="path-length regularization weight (0 = off; StyleGAN2 uses 2)")
    ap.add_argument("--resume", default=None, help="a snapshot directory")
    ap.add_argument("--metrics", default="",
                    help="comma list (e.g. fid,kid) evaluated on G_ema at every snapshot and at "
                         "the end, reported to metric-<name>.jsonl")
    ap.add_argument("--metric-items", type=int, default=500)
    ap.add_argument("--metric-detector", choices=["pixel", "inception", "vgg16"], default="pixel")
    ap.add_argument("--metric-detector-weights", default=None,
                    help="torch state_dict (.pth) for the metric detector")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--preset", choices=["full", "small", "tiny"], default="full",
                    help="tiny = smoke-test scale (CPU); small = 64px validation scale")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import mesh

    device_type = torch.device(args.device).type
    return mesh.launch(_train, mesh.dp_world(args.batch, device_type), device_type, args)


def _train(group, args):
    import numpy as np
    import torch

    from ..data.dataset import CameraLabeledDataset, infinite_loader
    from ..io.checkpoint import load_checkpoint, save_checkpoint
    from ..models.discriminator import Discriminator, DiscriminatorConfig
    from ..models.generator import Ide3dGenerator
    from ..parallel import mesh
    from ..parallel.stats import StatsAccumulator
    from ..render.camera import CANONICAL_POSE_25
    from ..train.augment import AdaState, AugmentConfig, ada_accumulate, ada_init, ada_update
    from ..train.gan import GanTrainConfig, d_input_channels, init_gan_state, make_gan_train_step
    from ..utils.profiling import check_replica_consistency
    from ..utils.seg import mask2color
    from .common import PRESETS, save_image_grid

    device, main_rank = group.device, group.is_main
    log = print if main_rank else (lambda *a, **k: None)
    if main_rank:
        os.makedirs(args.outdir, exist_ok=True)
    gcfg = dataclasses.replace(PRESETS[args.preset], img_resolution=args.resolution)
    if args.r1_gamma is None:
        args.r1_gamma = 0.0002 * gcfg.img_resolution ** 2 / args.batch
        log(f"r1-gamma (auto): {args.r1_gamma:.3g}")
    tcfg = GanTrainConfig(r1_gamma=args.r1_gamma, use_ada=not args.no_ada,
                          pl_weight=args.pl_weight, aug=AugmentConfig(wavelet_aa=args.wavelet_aa))
    G = Ide3dGenerator(gcfg).init(args.seed).to(device)
    D = Discriminator(DiscriminatorConfig(img_resolution=gcfg.img_resolution,
                                          img_channels=d_input_channels(tcfg, gcfg)))
    D = D.init(args.seed + 1).to(device)
    state = init_gan_state(G, D, tcfg)
    log(f"device: {device}; {group.size} rank(s) over {group.backend}; global batch {args.batch}")

    dataset = CameraLabeledDataset(args.data, args.seg, resolution=args.resolution, xflip=True)
    loader = mesh.prefetch_to_device(
        infinite_loader(dataset, args.batch, seed=args.seed, rank=group.rank,
                        world_size=group.size), device)

    ada, ada_p = ada_init(), 0.0
    if args.resume:
        saved, meta = load_checkpoint(args.resume) if main_rank else (None, None)
        saved, meta = mesh.broadcast_tree(group, (saved, meta))
        for name, obj in (("G", state.G), ("D", state.D), ("G_ema", state.G_ema),
                          ("opt_g", state.opt_g), ("opt_d", state.opt_d)):
            obj.load_state_dict(saved[name])
        state.pl_mean = saved["pl_mean"].to(device)
        state.step = int(meta.get("step", 0))
        ada_p = float(meta.get("ada_p", 0.0))
        ada = AdaState(p=ada_p, rt_accum=(0.0, 0.0))
    mesh.replicate(group, state.G, state.D, state.G_ema)
    if args.fixed_ada_p is not None:
        ada_p = args.fixed_ada_p
    step_fn = make_gan_train_step(tcfg, group)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    acc = StatsAccumulator(group)

    metric_names = [m.strip() for m in args.metrics.split(",") if m.strip()]
    metric_done = set()
    if metric_names:
        from ..metrics import calc_metric, make_detector

        met_det = make_detector(args.metric_detector, args.metric_detector_weights, device=device)
        # The real statistics come from the un-mirrored dataset (the training
        # loader's xflip copies would otherwise enter the cached real bank).
        metric_dataset = CameraLabeledDataset(args.data, args.seg, resolution=args.resolution,
                                              xflip=False)

    def eval_metrics(kimg):
        if not metric_names or kimg in metric_done:  # the final save can meet a snapshot
            return
        metric_done.add(kimg)
        for name in metric_names:
            rec = calc_metric(name, G=state.G_ema, dataset=metric_dataset, detector=met_det,
                              num_items=args.metric_items, batch_size=args.batch,
                              cache_dir=os.path.join(args.outdir, ".metric_cache"), device=device,
                              group=group)
            if main_rank:
                line = {"kimg": kimg, **rec}
                print(json.dumps(line, default=float))
                with open(os.path.join(args.outdir, f"metric-{name}.jsonl"), "a") as f:
                    f.write(json.dumps(line, default=float) + "\n")

    grid_z = torch.as_tensor(np.random.RandomState(1).randn(16, gcfg.z_dim), dtype=torch.float32,
                             device=device)
    grid_c = torch.as_tensor(CANONICAL_POSE_25, device=device)[None].expand(16, -1)

    def save_grid(cur_img):
        with torch.inference_mode():
            ws = state.G_ema.mapping(grid_z, grid_c, truncation_psi=0.7)
            img, seg = state.G_ema.synthesis(ws, grid_c, return_seg=True)
        name = os.path.join(args.outdir, f"fakes{cur_img // 1000:06d}")
        save_image_grid(img.cpu().numpy(), name + ".png", grid=(4, 4))
        save_image_grid(mask2color(seg).cpu().numpy() / 127.5 - 1.0, name + "_seg.png", grid=(4, 4))

    def save(name):
        if not check_replica_consistency(group, state.G, state.D, state.G_ema):
            raise RuntimeError(f"{name}: the ranks' G, D or G_ema differ")
        if main_rank:
            save_checkpoint(os.path.join(args.outdir, name),
                            {"G": state.G.state_dict(), "D": state.D.state_dict(),
                             "G_ema": state.G_ema.state_dict(), "opt_g": state.opt_g.state_dict(),
                             "opt_d": state.opt_d.state_dict(), "pl_mean": state.pl_mean},
                            config=gcfg, step=state.step, ada_p=ada_p)

    cur_img = state.step * args.batch
    next_snap = cur_img + args.snap_kimg * 1000
    next_grid = cur_img
    t_start = time.time()
    sign_buf = []  # the steps' sign statistics, read back at the controller's update

    while cur_img < args.kimg * 1000:
        state, stats = step_fn(state, next(loader), gen, ada_p)
        cur_img += args.batch
        acc.update(stats)
        if not args.no_ada and args.fixed_ada_p is None:
            # Keep the device scalars and read them every 4 steps: a readback
            # per step would wait for each step to finish before the next is queued.
            sign_buf.append(stats["real_signs"])
            if (cur_img // args.batch) % 4 == 0:
                for s in sign_buf:
                    ada = ada_accumulate(ada, s, args.batch, group)
                sign_buf.clear()
                ada = ada_update(ada, args.batch * 4, target=args.ada_target,
                                 speed_kimg=args.ada_speed, p_max=args.ada_pmax)
                ada_p = float(ada.p)

        if cur_img % (args.batch * 100) == 0:  # interval means (R1 fires on a sub-interval)
            line = {"kimg": cur_img / 1000, "time_h": (time.time() - t_start) / 3600,
                    "ada_p": ada_p, **{k: acc.mean(k) for k in sorted(stats)}}
            acc.reset()
            if main_rank:
                print(json.dumps(line))
                with open(os.path.join(args.outdir, "stats.jsonl"), "a") as f:
                    f.write(json.dumps(line) + "\n")
        if cur_img >= next_grid:
            if main_rank:
                save_grid(cur_img)
            next_grid = cur_img + args.grid_kimg * 1000
        if cur_img >= next_snap:
            save(f"snapshot-{cur_img // 1000:06d}")
            eval_metrics(cur_img / 1000)
            next_snap = cur_img + args.snap_kimg * 1000

    if sign_buf:  # ended mid-window: the final ada_p reflects every step
        for s in sign_buf:
            ada = ada_accumulate(ada, s, args.batch, group)
        ada = ada_update(ada, args.batch * len(sign_buf), target=args.ada_target,
                         speed_kimg=args.ada_speed, p_max=args.ada_pmax)
        ada_p = float(ada.p)
    save("snapshot-final")
    eval_metrics(cur_img / 1000)
    loader.close()
    log("done")
    return state if main_rank else None


if __name__ == "__main__":
    main()
