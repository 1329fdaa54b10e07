"""PTI inversion pipeline (counterpart of ide3d_tpu/apps/run_pti.py).

Per input image: an optional warm start (e4e pivots with `--e4e`, else the
hybrid encoder with `--encoder` and `--masks`) -> the w+ projector -> pivotal
tuning of G around the pivot, which inherits the projector's noise buffers.
Writes the pivot (`<name>.npz`, key `ws`), the camera label
(`<name>_label.npz`, key `c`), the tuned generator `model_<name>` (a snapshot
that apps.common.load_generator reads back), the target / reconstruction pair
`<name>_compare.png` and, with `--video`, a 60-frame orbit `<name>_orbit.mp4`.
`--multi-id` tunes ONE generator over all pivots in turn (`model_multi_id`).

Usage:
    python -m ide3d_tpu_torch.apps.run_pti --network random:0 --images face.png \\
        --outdir pti_out/ [--encoder ckpt --masks masks/ | --e4e e4e.pt] [--multi-id] \\
        [--join-view] [--use-locality] [--video] [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU. Image i's draws come from
a torch.Generator seeded i (the JAX CLI keys its projector with PRNGKey(i)).
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import math
import os

import numpy as np


def _image_files(images: str) -> list:
    if os.path.isdir(images):
        return sorted(sum((glob.glob(os.path.join(images, e)) for e in ("*.png", "*.jpg", "*.jpeg")), []))
    return sorted(glob.glob(images))


def _with_noise(G, noise: dict):
    """A copy of G with the projector's noise buffers merged in (G itself when
    there are none: --no-noise-opt)."""
    if not noise:
        return G
    from ..train.pti import merge_noise

    G = copy.deepcopy(G)
    merge_noise(G.synthesis, noise)
    return G


def _save_viz(G, w_pivot, target, c, args, name) -> None:
    """`<name>_compare.png` (target over G's render of the pivot) and, with
    --video, the 60-frame orbit; every render deterministic."""
    import torch

    from ..render.camera import look_at_pose, make_label_25
    from .common import save_image_grid, write_video

    with torch.no_grad():
        recon = G.synthesis(w_pivot, c, noise_mode="const")
        pair = torch.cat([target, recon], dim=0).cpu().numpy()
        save_image_grid(pair, os.path.join(args.outdir, f"{name}_compare.png"), grid=(2, 1))
        if not args.video:
            return
        frames = []
        for i in range(60):
            yaw = math.pi / 2 + 0.5 * math.sin(2 * math.pi * i / 60)
            cam = make_label_25(look_at_pose(yaw, math.pi / 2, [0.0, 0.0, 0.2], radius=2.7,
                                             device=c.device))
            img = G.synthesis(w_pivot, cam, noise_mode="const")
            frames.append(((img[0] + 1) * 127.5).round().clamp(0, 255).to(torch.uint8).cpu().numpy())
    write_video(os.path.join(args.outdir, f"{name}_orbit.mp4"), frames, fps=24)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--images", required=True, help="image file, glob, or directory")
    ap.add_argument("--masks", default=None, help="directory of masks for the encoder warm start")
    ap.add_argument("--encoder", default=None, help="HybridEncoder checkpoint for initial_w")
    ap.add_argument("--e4e", default=None,
                    help="e4e/pSp .pt checkpoint: first-stage e4e pivots; takes precedence "
                         "over --encoder")
    ap.add_argument("--e4e-variant", default="auto", choices=("auto", "e4e", "gradual"),
                    help="encoder architecture in the --e4e checkpoint (weight-isomorphic, so "
                         "shapes can't tell them apart): 'auto' reads opts.encoder_type and "
                         "warns when guessing")
    ap.add_argument("--labels", default=None, help="json {fname: 25-dim pose}; default front")
    ap.add_argument("--opencv-labels", action="store_true",
                    help="--labels values are in the dataset.json OpenCV convention; apply the "
                         "OpenCV->OpenGL sign flip before use")
    ap.add_argument("--projector-steps", type=int, default=450)
    ap.add_argument("--pti-steps", type=int, default=350)
    ap.add_argument("--lpips-threshold", type=float, default=0.06)
    ap.add_argument("--multi-id", action="store_true")
    ap.add_argument("--video", action="store_true")
    ap.add_argument("--join-view", action="store_true",
                    help="join-view coach: add the mirrored-view consistency term")
    ap.add_argument("--use-locality", action="store_true",
                    help="ball-holder locality regularization")
    ap.add_argument("--no-noise-opt", action="store_true",
                    help="disable joint per-layer noise-buffer optimization")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..io.checkpoint import save_checkpoint
    from ..render.camera import CANONICAL_POSE_25
    from ..train.pti import ProjectorConfig, PtiConfig, pivotal_tune, project_w_plus
    from .common import load_generator
    from .infer_hybrid_encoder import build_encoder, load_image, load_mask

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    R = G.cfg.img_resolution
    os.makedirs(args.outdir, exist_ok=True)
    files = _image_files(args.images)
    if not files:
        raise SystemExit(f"no images match {args.images}")

    labels = {}
    if args.labels:
        with open(args.labels) as f:
            labels = dict(json.load(f))
        if args.opencv_labels:
            def _cv2gl(v):
                v = np.asarray(v, np.float32).copy()
                v[[1, 2, 5, 6, 9, 10]] *= -1
                return v

            labels = {k: _cv2gl(v) for k, v in labels.items()}

    e4e_fn = None
    if args.e4e:
        from .common import make_e4e_pivot_fn

        e4e_fn, e4e_report = make_e4e_pivot_fn(G, args.e4e, args.e4e_variant, device)
        print(f"e4e: {e4e_report}")
    E = build_encoder(G, args.encoder, device) if args.encoder else None

    pcfg = ProjectorConfig(num_steps=args.projector_steps, optimize_noise=not args.no_noise_opt)
    tcfg = PtiConfig(max_steps=args.pti_steps, lpips_threshold=args.lpips_threshold,
                     join_view=args.join_view, use_locality=args.use_locality)

    pivots = []
    for fi, f in enumerate(files):
        name = os.path.splitext(os.path.basename(f))[0]
        target = torch.as_tensor(load_image(f, R), device=device)[None]
        c = torch.as_tensor(np.asarray(labels.get(os.path.basename(f), CANONICAL_POSE_25),
                                       np.float32), device=device).reshape(1, 25)

        initial_w = None
        if e4e_fn is not None:
            initial_w = e4e_fn(target)
        elif E is not None and args.masks:
            from ..utils.seg import mask2onehot

            mask_path = os.path.join(args.masks, os.path.basename(f))
            if os.path.exists(mask_path):
                with torch.no_grad():
                    mask = torch.as_tensor(load_mask(mask_path, R), device=device)[None]
                    initial_w = E(target, mask2onehot(mask) * 2 - 1) + G.mapping.w_avg[None, None]

        print(f"[{fi + 1}/{len(files)}] projecting {name} ...")
        gen = torch.Generator(device=device).manual_seed(fi)
        w_pivot, noise = project_w_plus(G, target, c, pcfg, initial_w=initial_w, generator=gen,
                                        verbose=True, return_noise=True)
        np.savez(os.path.join(args.outdir, f"{name}.npz"), ws=w_pivot.cpu().numpy())
        np.savez(os.path.join(args.outdir, f"{name}_label.npz"), c=c.cpu().numpy())
        pivots.append((name, w_pivot, noise, target, c))

        if not args.multi_id:
            print(f"tuning G around pivot {name} ...")
            # The pivot was optimized jointly with these noise buffers: PTI tunes
            # a G that holds them (the reference projector writes G's buffers).
            tuned = pivotal_tune(_with_noise(G, noise), w_pivot, target, c, tcfg,
                                 generator=gen, verbose=True)
            save_checkpoint(os.path.join(args.outdir, f"model_{name}"),
                            {"G_ema": tuned.state_dict()}, config=G.cfg)
            _save_viz(tuned, w_pivot, target, c, args, name)
            del tuned

    if args.multi_id:
        # One generator tuned over the pivots in turn; each pivot's projector
        # noise is merged just before its pass.
        print("multi-id tuning over all pivots ...")
        tuned = G
        mcfg = PtiConfig(max_steps=max(tcfg.max_steps // len(pivots), 20),
                         lpips_threshold=tcfg.lpips_threshold)
        for name, w_pivot, noise, target, c in pivots:
            tuned = pivotal_tune(_with_noise(tuned, noise), w_pivot, target, c, mcfg)
        save_checkpoint(os.path.join(args.outdir, "model_multi_id"), {"G_ema": tuned.state_dict()},
                        config=G.cfg)
        for name, w_pivot, noise, target, c in pivots:
            _save_viz(tuned, w_pivot, target, c, args, name)

    print(f"done: {args.outdir}")


if __name__ == "__main__":
    main()
