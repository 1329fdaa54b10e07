"""Hybrid-encoder training (counterpart of ide3d_tpu/apps/train_hybrid_encoder.py).

Usage:
    python -m ide3d_tpu_torch.apps.train_hybrid_encoder --network <G snapshot|random:0> \\
        --data imgs/ --seg segs/ --outdir runs/e0 --batch 8 --max-steps 100000 \\
        [--bisenet segNet-20Class.pth] [--vgg-weights vgg19.pth] [--lpips-weights lpips.pth] \\
        [--arcface-weights model_ir_se50.pth] [--resume runs/e0/encoder-00010000] [--device cuda]

One step covers the synthetic and the real branch (train/encoder.py), data
parallel over the visible cards (one rank per card over NCCL, gloo with
`--device cpu`; torchrun's world when it launched the process), reduced to
the largest world that divides --batch, as the JAX app's mesh (the reference
trained the encoder under DDP). G, BiSeNet and the loss networks are frozen;
rank 0's G and E are broadcast, the loss networks read from their files on
every rank. Each rank reads its rows of the global batch (the
compact uint8 batches of the port's CameraLabeledDataset, copied from pinned
memory on a side stream) and expands them on its card. Every 100 steps rank 0
writes a line of the losses, averaged over the ranks, to stats.jsonl, and
snapshots `encoder-<step>` (io/checkpoint: E, opt_e, the step) every --snap
steps and at the end, after checking the ranks' E equal. `--resume` (read by
rank 0, broadcast) restores E, Adam and the step; the draws restart from
--seed. The loss networks' files are torch state dicts: VGG19's trunk
(`features.*`), the LPIPS trunk and weights (`vgg.features.*`, `lin0..4.weight`),
IR-SE50 (`model_ir_se50.pth` names).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def load_loss_networks(args, device):
    """(bisenet, vgg_feats, lpips_fn, id_embed) from the CLI's weight files, each
    None when its file is not given; frozen, in eval mode, on `device`."""
    from ..metrics.features import VGG16Features, load_state_dict_file
    from ..metrics.lpips import LPIPS
    from ..models.arcface import ArcFaceIRSE50

    def frozen(m):
        return m.to(device).eval().requires_grad_(False)

    bisenet = vgg_feats = lpips_fn = id_embed = None
    if args.bisenet:
        from ..io.torch_import import import_bisenet

        bisenet = import_bisenet(args.bisenet, device=device).requires_grad_(False)
    if args.vgg_weights:
        vgg = frozen(load_state_dict_file(VGG16Features(cfg_name="vgg19"), args.vgg_weights,
                                          prefixes=("features.",)))
        vgg_feats = vgg.feature_maps
    if args.lpips_weights:
        lpips_fn = frozen(load_state_dict_file(LPIPS(), args.lpips_weights,
                                               prefixes=("vgg.features.", "lin")))
    if args.arcface_weights:
        id_embed = frozen(load_state_dict_file(ArcFaceIRSE50(), args.arcface_weights)).embed_faces
    return bisenet, vgg_feats, lpips_fn, id_embed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--data", default=None)
    ap.add_argument("--seg", default=None)
    ap.add_argument("--bisenet", default=None)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-steps", type=int, default=100000)
    ap.add_argument("--snap", type=int, default=10000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--truncation", type=float, default=1.0)
    ap.add_argument("--no-gen-branch", action="store_true")
    ap.add_argument("--vgg-weights", default=None, help="torch VGG19 state_dict for the perceptual loss")
    ap.add_argument("--lpips-weights", default=None, help="torch LPIPS state_dict")
    ap.add_argument("--arcface-weights", default=None, help="torch IR-SE50 state_dict for the ID loss")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import mesh

    device_type = torch.device(args.device).type
    return mesh.launch(_train, mesh.dp_world(args.batch, device_type), device_type, args)


def _train(group, args):
    import numpy as np
    import torch

    from ..io.checkpoint import load_checkpoint, save_checkpoint
    from ..models.encoder import HybridEncoder
    from ..parallel import mesh
    from ..parallel.stats import StatsAccumulator
    from ..render.camera import CANONICAL_POSE_25
    from ..train.encoder import EncoderTrainConfig, init_encoder_state, make_encoder_train_step
    from ..utils.profiling import check_replica_consistency
    from .common import load_generator

    device, main_rank = group.device, group.is_main
    if main_rank:
        os.makedirs(args.outdir, exist_ok=True)
    G = load_generator(args.network, device).requires_grad_(False)
    R, n_geo = G.cfg.img_resolution, G.synthesis.num_ws_geo
    E = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo,
                      w_dim=G.cfg.w_dim, input_seg_dim=G.cfg.seg_channels).init(args.seed)
    E = E.to(device).train()
    tcfg = EncoderTrainConfig(lr=args.lr, truncation=args.truncation,
                              train_gen=not args.no_gen_branch, train_real=args.data is not None)
    state = init_encoder_state(E, tcfg)
    if args.resume:
        saved, meta = load_checkpoint(args.resume) if main_rank else (None, None)
        saved, meta = mesh.broadcast_tree(group, (saved, meta))
        state.E.load_state_dict(saved["E"])
        state.opt_e.load_state_dict(saved["opt_e"])
        state.step = int(meta.get("step") or 0)
    bisenet, vgg_feats, lpips_fn, id_embed = load_loss_networks(args, device)
    mesh.replicate(group, G, state.E)
    step_fn = make_encoder_train_step(E, G, tcfg, bisenet=bisenet, vgg_feats=vgg_feats,
                                      lpips_fn=lpips_fn, id_embed=id_embed, group=group)

    loader = None
    if args.data:
        from ..data.dataset import CameraLabeledDataset, infinite_loader

        loader = mesh.prefetch_to_device(
            infinite_loader(CameraLabeledDataset(args.data, args.seg, resolution=R), args.batch,
                            seed=args.seed, rank=group.rank, world_size=group.size), device)
    c_front = torch.as_tensor(np.broadcast_to(CANONICAL_POSE_25, (args.batch, 25)).copy(),
                              device=device)[mesh.rows(group, args.batch)]
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    if main_rank:
        print(f"device: {device}; {group.size} rank(s) over {group.backend}; global batch "
              f"{args.batch}; from step {state.step}")

    t0 = time.time()
    for i in range(state.step, args.max_steps):
        batch = next(loader) if loader is not None else {"c": c_front}
        state, stats = step_fn(state, batch, gen)
        if i % 100 == 0:
            acc = StatsAccumulator(group)
            acc.update(stats)
            line = {"step": i, "time_h": (time.time() - t0) / 3600, **acc.as_dict()}
            if main_rank:
                print(json.dumps(line))
                with open(os.path.join(args.outdir, "stats.jsonl"), "a") as f:
                    f.write(json.dumps(line) + "\n")
        if (i + 1) % args.snap == 0 or (i + 1) == args.max_steps:
            if not check_replica_consistency(group, state.E):
                raise RuntimeError(f"step {i + 1}: the ranks' E differ")
            if main_rank:
                save_checkpoint(os.path.join(args.outdir, f"encoder-{i + 1:08d}"),
                                {"E": state.E.state_dict(), "opt_e": state.opt_e.state_dict()},
                                step=i + 1)
    if loader is not None:
        loader.close()
    if main_rank:
        print("done")
    return state if main_rank else None


if __name__ == "__main__":
    main()
