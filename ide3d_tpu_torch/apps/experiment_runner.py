"""Inversion experiment orchestration (counterpart of
ide3d_tpu/apps/experiment_runner.py): one command from a folder of images to
every per-method latent artifact the edit-comparison harness consumes.

Reference contract: `inversion/evaluation/experiment_setting_creator.py`
(ExperimentRunner.run_experiment chains run_PTI and the SG2+/e4e latent
creators over `paths_config.input_data_path` before a qualitative comparison).
This analogue chains the repo's own CLIs in-process with a consistent output
layout, then (optionally) runs the comparison itself:

    <outdir>/pti/          apps/run_pti.py artifacts (pivots + tuned G)
    <outdir>/lat_sg2plus/  apps/latent_creator.py projector latents
    <outdir>/lat_e4e/      apps/latent_creator.py one-shot e4e latents
    <outdir>/comparison/   apps/edit_comparison.py strips (with --compare)

Usage:
    python -m ide3d_tpu_torch.apps.experiment_runner --network snap/ --images faces/ \
        --outdir exp/ [--no-pti] [--create-other-latents] [--multi-id] \
        [--e4e e4e.pt] [--encoder enc/] [--labels labels.json] [--compare] [--device cuda]

Runs on the card; `--device cpu` runs every leg on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--images", required=True, help="folder of target images")
    ap.add_argument("--outdir", required=True)
    # reference run_experiment(run_pt=True, create_other_latents=False, ...)
    ap.add_argument("--no-pti", action="store_true",
                    help="skip the PTI leg (run_experiment run_pt=False)")
    ap.add_argument("--create-other-latents", action="store_true",
                    help="also run the SG2+ projector (and, with --e4e, the "
                         "one-shot e4e) latent creators")
    ap.add_argument("--multi-id", action="store_true",
                    help="PTI leg tunes ONE generator over all images "
                         "(use_multi_id_training)")
    ap.add_argument("--compare", action="store_true",
                    help="finish with apps/edit_comparison.py over the "
                         "produced artifacts")
    ap.add_argument("--encoder", default=None,
                    help="HybridEncoder ckpt for projector warm starts")
    ap.add_argument("--masks", default=None,
                    help="mask dir for HybridEncoder warm starts")
    ap.add_argument("--e4e", default=None, help="e4e/pSp .pt checkpoint")
    ap.add_argument("--e4e-variant", default="auto",
                    choices=("auto", "e4e", "gradual"))
    ap.add_argument("--labels", default=None,
                    help="json {fname: 25-dim pose}; default front")
    ap.add_argument("--opencv-labels", action="store_true")
    ap.add_argument("--projector-steps", type=int, default=450)
    ap.add_argument("--pti-steps", type=int, default=350)
    ap.add_argument("--lpips-threshold", type=float, default=0.06)
    ap.add_argument("--directions", default=None,
                    help="npz of named InterFaceGAN directions (--compare)")
    ap.add_argument("--num-steps", type=int, default=None,
                    help="sampling-budget override passed to the comparison")
    ap.add_argument("--max-images", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = ["--device", args.device]

    os.makedirs(args.outdir, exist_ok=True)
    pti_dir = os.path.join(args.outdir, "pti")
    sg2_dir = os.path.join(args.outdir, "lat_sg2plus")
    e4e_dir = os.path.join(args.outdir, "lat_e4e")

    def _label_args():
        out = []
        if args.labels:
            out += ["--labels", args.labels]
            if args.opencv_labels:
                out += ["--opencv-labels"]
        return out

    if not args.no_pti:
        from .run_pti import main as run_pti_main

        pti_args = ["--network", args.network, "--images", args.images,
                    "--outdir", pti_dir,
                    "--projector-steps", str(args.projector_steps),
                    "--pti-steps", str(args.pti_steps),
                    "--lpips-threshold", str(args.lpips_threshold)]
        pti_args += _label_args()
        if args.multi_id:
            pti_args += ["--multi-id"]
        if args.e4e:
            pti_args += ["--e4e", args.e4e, "--e4e-variant", args.e4e_variant]
        elif args.encoder:
            pti_args += ["--encoder", args.encoder]
            if args.masks:
                pti_args += ["--masks", args.masks]
        print(f"[experiment] PTI leg -> {pti_dir}")
        rc = run_pti_main(pti_args + device)
        if rc:
            return rc

    if args.create_other_latents:
        from .latent_creator import main as latent_main

        sg2_args = ["--network", args.network, "--images", args.images,
                    "--steps", str(args.projector_steps), "--outdir", sg2_dir]
        # latent_creator reads labels as a json of 25-dim poses directly
        if args.labels:
            sg2_args += ["--labels", args.labels]
        if args.encoder:
            sg2_args += ["--encoder", args.encoder]
            if args.masks:
                sg2_args += ["--masks", args.masks]
        print(f"[experiment] SG2+ latent leg -> {sg2_dir}")
        rc = latent_main(sg2_args + device)
        if rc:
            return rc
        if args.e4e:
            e4e_args = ["--network", args.network, "--images", args.images,
                        "--e4e", args.e4e, "--e4e-variant", args.e4e_variant,
                        "--outdir", e4e_dir]
            if args.labels:
                e4e_args += ["--labels", args.labels]
            print(f"[experiment] e4e latent leg -> {e4e_dir}")
            rc = latent_main(e4e_args + device)
            if rc:
                return rc

    if args.compare:
        from .edit_comparison import main as compare_main

        cmp_args = ["--network", args.network, "--images", args.images,
                    "--outdir", os.path.join(args.outdir, "comparison"),
                    "--max-images", str(args.max_images)]
        if not args.no_pti:
            cmp_args += ["--pti", pti_dir]
        if args.create_other_latents:
            cmp_args += ["--latents", f"SG2Plus={sg2_dir}"]
            if args.e4e:
                cmp_args += ["--latents", f"e4e={e4e_dir}"]
        if args.directions:
            cmp_args += ["--directions", args.directions]
        if args.num_steps:
            cmp_args += ["--num-steps", str(args.num_steps)]
        print("[experiment] comparison leg")
        rc = compare_main(cmp_args + device)
        if rc:
            return rc

    print(f"[experiment] done -> {args.outdir}")
    return 0


if __name__ == "__main__":
    main()
