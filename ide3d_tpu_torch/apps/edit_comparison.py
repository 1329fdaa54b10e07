"""Qualitative edit-comparison harness (counterpart of
ide3d_tpu/apps/edit_comparison.py; the reference's
inversion/evaluation/qualitative_edit_comparison.py).

For every inverted image, the reconstruction and a sweep of latent edits
(an InterFaceGAN factor ladder per direction, a GANSpace component ladder)
for each inversion method, side by side: single frames of the PTI method and
concatenated strips [target | method rows...]. Inputs are the port's own
artifacts:
  * `--pti` dir from apps/run_pti (`<name>.npz` pivots, `<name>_label.npz`,
    `model_<name>` or `model_multi_id` tuned snapshots: the 'PTI' method),
  * any `--latents NAME=dir` from apps/latent_creator, rendered with the
    untuned generator,
  * `--directions npz` (named InterFaceGAN normals [w_dim]) and the GANSpace
    PCA of 256 w samples of the untuned generator (editing/latent_editor).

Factor ladders as the reference: InterFaceGAN ±3.0 step 0.5 (0 excluded),
GANSpace -20..20 step 5 (qualitative_edit_comparison.py:102-103).

    python -m ide3d_tpu_torch.apps.edit_comparison --network random:0 \\
        --images faces/ --pti pti_out/ --latents e4e=lat_e4e/ --outdir cmp/ [--device cuda]

Runs on the card; `--device cpu` runs it on the CPU. The PCA's z come from a
torch.Generator seeded 0 on the device.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True)
    ap.add_argument("--images", required=True, help="folder of target images")
    ap.add_argument("--pti", default=None, help="apps/run_pti.py output dir")
    ap.add_argument("--latents", action="append", default=[],
                    metavar="NAME=DIR", help="latent_creator output dirs")
    ap.add_argument("--directions", default=None,
                    help="npz of named InterFaceGAN direction vectors [w_dim]")
    ap.add_argument("--interfacegan-max", type=float, default=3.0)
    ap.add_argument("--interfacegan-step", type=float, default=0.5)
    ap.add_argument("--ganspace-components", type=int, default=2)
    ap.add_argument("--ganspace-factors", default="-20,25,5",
                    help="start,stop,step (reference range(-20, 25, 5))")
    ap.add_argument("--max-images", type=int, default=8)
    ap.add_argument("--num-steps", type=int, default=None,
                    help="override sampling budget (faster previews)")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from ..editing.latent_editor import apply_ganspace_edit, apply_interfacegan, compute_ganspace_pca
    from ..render.camera import CANONICAL_POSE_25
    from .common import load_generator, save_image_grid
    from .infer_hybrid_encoder import load_image

    device = torch.device(args.device)
    G = load_generator(args.network, device)
    rp = G.cfg.render
    if args.num_steps:
        rp = dataclasses.replace(rp, num_steps=args.num_steps)
    R = G.cfg.img_resolution

    def synth(g, ws, c):
        with torch.no_grad():
            return g.synthesis(ws, c, render_params=rp).float()

    def to_u8(img):
        return np.asarray(((img + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu())

    # ---- methods: name -> ({image: G}, {image: ws}) -------------------------
    files = sorted(sum((glob.glob(os.path.join(args.images, e))
                        for e in ("*.png", "*.jpg", "*.jpeg")), []))[: args.max_images]
    if not files:
        raise SystemExit(f"no images in {args.images}")
    names = [os.path.splitext(os.path.basename(f))[0] for f in files]

    methods = {}  # insertion order = row order in the strips
    for spec in args.latents:
        mname, mdir = spec.split("=", 1)
        ws = {n: np.load(os.path.join(mdir, f"{n}.npz"))["ws"] for n in names
              if os.path.exists(os.path.join(mdir, f"{n}.npz"))}
        methods[mname] = ({n: G for n in ws}, ws)
    if args.pti:
        ws, tuned, loaded = {}, {}, {}
        for n in names:
            pnpz = os.path.join(args.pti, f"{n}.npz")
            if not os.path.exists(pnpz):
                continue
            ws[n] = np.load(pnpz)["ws"]
            ck = os.path.join(args.pti, f"model_{n}")
            ck = ck if os.path.exists(ck) else os.path.join(args.pti, "model_multi_id")
            if os.path.exists(ck):
                if ck not in loaded:
                    loaded[ck] = load_generator(ck, device)
                tuned[n] = loaded[ck]
            else:
                tuned[n] = G
        methods["PTI"] = (tuned, ws)
    if not methods:
        raise SystemExit("provide --pti and/or --latents")

    # ---- cameras + edit directions ------------------------------------------
    def label_for(n):
        for d in [args.pti] + [s.split("=", 1)[1] for s in args.latents]:
            if d and os.path.exists(os.path.join(d, f"{n}_label.npz")):
                return np.load(os.path.join(d, f"{n}_label.npz"))["c"]
        return CANONICAL_POSE_25[None]

    directions = {}
    if args.directions:
        directions = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                      for k, v in np.load(args.directions).items()}
    gs_lo, gs_hi, gs_step = (int(x) for x in args.ganspace_factors.split(","))
    gs_factors = list(range(gs_lo, gs_hi, gs_step))
    if_factors = [f for f in np.arange(-args.interfacegan_max, args.interfacegan_max + 1e-6,
                                       args.interfacegan_step) if abs(f) > 1e-9]
    # the GANSpace basis from the untuned generator's w distribution
    pca = compute_ganspace_pca(G, n_samples=256, generator=torch.Generator(device=device).manual_seed(0),
                               n_components=max(args.ganspace_components, 1))

    # ---- render loop ---------------------------------------------------------
    os.makedirs(args.outdir, exist_ok=True)
    for n, f in zip(names, files):
        base = os.path.join(args.outdir, n)
        single = os.path.join(base, "single_images")
        concat = os.path.join(base, "concat_images")
        os.makedirs(single, exist_ok=True)
        os.makedirs(concat, exist_ok=True)
        target = load_image(f, R)[None]
        save_image_grid(target, os.path.join(single, "Original.jpg"))
        c = torch.as_tensor(np.asarray(label_for(n), np.float32), device=device).reshape(1, 25)

        def rows_for(edit_fn, tag):
            """One strip: [target | method rows...] for one latent edit."""
            row_imgs = [np.clip((target[0] + 1) * 127.5, 0, 255).astype(np.uint8)]
            for mname, (mg, mws) in methods.items():
                if n not in mws:
                    continue
                ws = torch.as_tensor(mws[n], dtype=torch.float32, device=device)
                ws = ws[None] if ws.ndim == 2 else ws
                img = synth(mg[n], edit_fn(ws), c)
                row_imgs.append(to_u8(img[0]))
                if mname == "PTI":  # the reference saves singles for the new G only
                    save_image_grid(img.cpu().numpy(), os.path.join(single, f"{tag}.jpg"))
            strip = np.concatenate(row_imgs, axis=1)[None].astype(np.float32) / 127.5 - 1.0
            save_image_grid(strip, os.path.join(concat, f"{tag}.jpg"))

        rows_for(lambda ws: ws, "rec")
        for dname, dvec in directions.items():
            for fac in if_factors:
                rows_for(lambda ws, d=dvec, f2=fac: apply_interfacegan(ws, d, f2), f"{dname}_{fac}")
        for ci in range(args.ganspace_components):
            for fac in gs_factors:
                rows_for(lambda ws, i=ci, f2=fac: apply_ganspace_edit(
                    ws, pca, [(i, 0, G.num_ws, float(f2))]), f"ganspace_c{ci}_{fac}")
        print(f"{n}: wrote {base}")
    print(f"done: {args.outdir}")


if __name__ == "__main__":
    main()
