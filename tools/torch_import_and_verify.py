"""Real-checkpoint readiness harness with the PyTorch port: import a reference
.pkl and verify it (counterpart of tools/import_and_verify.py, same flags,
stages and exit codes, plus --device).

    python tools/torch_import_and_verify.py ide3d-ffhq-64-512.pkl --outdir out/verify \\
        [--data ffhq_dir --metric-items 200] [--extra-map map.json] [--device cuda]

Pipeline (each stage prints what it did; non-zero exit on failure):
  1. import  — io.torch_import.load_network_pkl: G_ema/G/D/E -> the port's
               modules, the full ImportReport per entry printed.
  2. abort gates — exits 3 if any entry fails to import or there is no
               generator; exits 2 if the generator has renderer-decoder leaves
               the shape auto-mapper could not recover unambiguously, unless
               --allow-missing (silently mis-assigned decoder weights are what
               the gate exists for). --extra-map routes named tensors.
  3. save    — a port snapshot (io/checkpoint, config embedded) at
               <outdir>/ckpt ({G_ema, D?, E?} state dicts), loadable by every
               CLI's --network.
  4. goldens — <outdir>/golden_import.npz: mapping ws + rgb/seg synthesis
               outputs for seeds 0-3 at the canonical pose; --check-golden
               compares against an earlier file (rtol = atol = 2e-2).
  5. render  — apps.gen_images seeds 0-3 from the saved snapshot into
               <outdir>/images.
  6. smoke   — D logits on a rendered frame and the E encode (when D/E were
               imported); apps.calc_metrics fid when --data is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _print_report(name, report):
    print(f"--- {name}: {report}")
    if report.auto_mapped:
        print("    auto-mapped (shape-unique renderer recovery):")
        for rec in report.auto_mapped:
            print(f"      {rec}")
    if report.missing_dest:
        print("    UNRECOVERED destination leaves (left at init values):")
        for leaf in report.missing_dest:
            print(f"      {leaf}")
    if report.skipped_source:
        print(f"    skipped source tensors ({len(report.skipped_source)}):")
        for s in report.skipped_source:
            print(f"      {s}")


def run(args) -> int:
    import numpy as np
    import torch

    from ide3d_tpu_torch.io.checkpoint import save_checkpoint
    from ide3d_tpu_torch.io.torch_import import load_network_pkl
    from ide3d_tpu_torch.metrics.features import resize
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    device = torch.device(args.device)
    extra_map = None
    if args.extra_map:
        with open(args.extra_map) as f:
            extra_map = {k: tuple(v) for k, v in json.load(f).items()}

    # ---- 1. import ------------------------------------------------------
    print(f"importing {args.pkl} (render_size={args.render_size}, num_steps={args.num_steps})")
    out = load_network_pkl(args.pkl, device=device, render_size=args.render_size,
                           num_steps=args.num_steps, dtype=args.dtype, extra_map=extra_map)
    failures = {k: v for k, v in out.items() if isinstance(v, Exception)}
    for k, e in failures.items():
        print(f"--- {k}: IMPORT FAILED: {type(e).__name__}: {e}")
    nets = {k: v for k, v in out.items() if not isinstance(v, Exception)}
    for k, (_, report) in nets.items():
        _print_report(k, report)
    if failures:
        return 3
    gkey = "G_ema" if "G_ema" in nets else ("G" if "G" in nets else None)
    if gkey is None:
        print("no generator entry (G_ema/G) in the pkl")
        return 3
    G, g_report = nets[gkey]

    # ---- 2. ambiguity abort gate ----------------------------------------
    leftover_renderer = [s for s in g_report.skipped_source if "render" in s.lower()]
    if g_report.missing_dest:
        print(f"\nAMBIGUOUS IMPORT: {len(g_report.missing_dest)} renderer-decoder "
              "leaves could not be recovered by unique-shape matching"
              + (f"; {len(leftover_renderer)} renderer-looking source tensors "
                 "left over" if leftover_renderer else "") + ".")
        print("Derive the explicit mapping (inspect names via "
              "io.torch_import.pickle_payload_to_state_dicts) and rerun with "
              "--extra-map; or rerun with --allow-missing to proceed with "
              "initialized leaves (NOT weight parity).")
        if not args.allow_missing:
            return 2
        print("--allow-missing: proceeding with initialized decoder leaves.")

    # ---- 3. native snapshot ---------------------------------------------
    os.makedirs(args.outdir, exist_ok=True)
    ckpt_dir = os.path.join(args.outdir, "ckpt")
    bundle = {"G_ema": G.state_dict()}  # every CLI's load path reads G_ema
    for k in ("D", "E"):
        if k in nets:
            bundle[k] = nets[k][0].state_dict()
    save_checkpoint(ckpt_dir, bundle, config=G.cfg, source_pkl=os.path.abspath(args.pkl),
                    import_report=str(g_report))
    print(f"saved native checkpoint -> {ckpt_dir}")

    # ---- 4. import goldens ----------------------------------------------
    golden_path = os.path.join(args.outdir, "golden_import.npz")
    cs = torch.as_tensor(CANONICAL_POSE_25, device=device)[None]
    golden = {}
    with torch.inference_mode():
        for seed in range(4):
            z = torch.as_tensor(np.random.RandomState(seed).randn(1, G.cfg.z_dim),
                                dtype=torch.float32, device=device)
            ws = G.mapping(z, cs)
            img, seg = G.synthesis(ws, cs, return_seg=True)
            golden[f"ws_{seed}"] = ws.float().cpu().numpy()
            golden[f"img_{seed}"] = img.float().cpu().numpy()
            golden[f"seg_{seed}"] = seg.float().cpu().numpy()
            assert np.isfinite(golden[f"img_{seed}"]).all(), f"seed {seed}: non-finite img"
    if args.check_golden:
        ref = np.load(args.check_golden)
        for k, v in golden.items():
            np.testing.assert_allclose(v, ref[k], rtol=2e-2, atol=2e-2,
                                       err_msg=f"golden drift in {k}")
        print(f"golden check vs {args.check_golden}: OK ({len(golden)} arrays)")
    np.savez(golden_path, **golden)
    print(f"wrote import goldens -> {golden_path}")

    # ---- 5. gen_images seeds 0-3 ----------------------------------------
    from ide3d_tpu_torch.apps import gen_images

    gen_images.main(["--network", ckpt_dir, "--seeds", "0-3", "--outdir",
                     os.path.join(args.outdir, "images"), "--num-steps", str(args.num_steps),
                     "--device", args.device])

    # ---- 6. smokes --------------------------------------------------------
    # The resizes are jax.image.resize(..., "bilinear"): antialiased when shrinking.
    with torch.inference_mode():
        if "D" in nets:
            D = nets["D"][0]
            R, ch = D.cfg.img_resolution, D.cfg.img_channels
            img0 = torch.as_tensor(golden["img_0"], device=device)
            rgb = resize(img0, R)
            parts = [rgb, rgb]  # rgb ++ (upsampled) raw branch
            have = 2 * img0.shape[-1]
            if ch > have:  # seg-conditioned D: append the semantic channels
                seg = resize(torch.as_tensor(golden["seg_0"], device=device)[..., :ch - have], R)
                parts.append(seg * 2.0 - 1.0)
            logits = D(torch.cat(parts, dim=-1)[..., :ch], cs).float().cpu().numpy()
            assert np.isfinite(logits).all(), "D logits non-finite"
            print(f"D smoke: logits {logits.ravel()[:4]}")
        if "E" in nets:
            E = nets["E"][0]
            r = 2 ** (E.img.num_blocks + 2)  # the HybridEncoder's input size
            img0 = resize(torch.as_tensor(golden["img_0"], device=device), r)
            seg0 = resize(torch.as_tensor(golden["seg_0"], device=device), r)
            ws = E(img0, seg0 * 2.0 - 1.0)
            assert bool(torch.isfinite(ws).all()), "E output non-finite"
            print(f"E smoke: rec_ws {tuple(ws.shape)}, std {float(ws.float().std()):.4f}")

    if args.data:
        from ide3d_tpu_torch.apps import calc_metrics

        argv = ["--network", ckpt_dir, "--data", args.data, "--metrics", "fid",
                "--num-items", str(args.metric_items), "--batch", "4",
                "--cache-dir", os.path.join(args.outdir, "metric_cache"), "--device", args.device]
        if args.detector_weights:
            argv += ["--detector", "inception", "--detector-weights", args.detector_weights]
        calc_metrics.main(argv)
    else:
        print("metric smoke skipped (pass --data <image dir> to run fid)")

    print("\nimport_and_verify: ALL STAGES PASSED")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pkl")
    ap.add_argument("--outdir", default="import_verify")
    ap.add_argument("--render-size", type=int, default=64)
    ap.add_argument("--num-steps", type=int, default=96)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--extra-map", default=None,
                    help="json file {torch_name: [dest, path, leaf]} routed "
                         "through import_generator(extra_map=)")
    ap.add_argument("--allow-missing", action="store_true",
                    help="proceed even when renderer leaves stay initialized")
    ap.add_argument("--check-golden", default=None,
                    help="previously written golden_import.npz to compare against")
    ap.add_argument("--data", default=None, help="real image dir for the fid smoke")
    ap.add_argument("--metric-items", type=int, default=200)
    ap.add_argument("--detector-weights", default=None,
                    help="InceptionV3 torch .pth for comparable fid numbers")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args)


if __name__ == "__main__":
    raise SystemExit(main())
