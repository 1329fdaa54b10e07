"""Export a generator as a frozen serving artifact (the port's export_model).

Counterpart of `python -m ide3d_tpu.apps.export_model`: writes the mapping
and the frame as saved `torch.export` programs with the weights embedded,
which `io.export.load_artifact` runs without the model code (io/export.py).

    python -m ide3d_tpu_torch.apps.export_model --network <snapshot|random:N> \
        --outdir artifact/ [--trunc 0.7] [--batch 1] [--platforms cuda,cpu]

The JAX CLI's flags, plus `--device` (default `cuda`; the CPU only when
asked), where G is loaded; `--platforms` defaults to that device's type.
`--check` reloads the artifact and renders one frame at the canonical pose
on each platform written.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True, help="snapshot dir or random:<seed>[:preset]")
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--trunc", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--num-steps", type=int, default=None,
                    help="override ray-sample budget (default: config)")
    ap.add_argument("--no-seg", action="store_true")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated devices to write programs for, e.g. cuda,cpu "
                         "(default: --device's type)")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and render one frame")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..io.export import export_generator, load_artifact
    from ..render.camera import CANONICAL_POSE_25
    from .common import load_generator

    G = load_generator(args.network, torch.device(args.device))
    rp = G.cfg.render
    if args.num_steps is not None:
        rp = dataclasses.replace(rp, num_steps=args.num_steps)
    platforms = args.platforms.split(",") if args.platforms else None

    meta = export_generator(
        G, args.outdir, batch=args.batch, truncation_psi=args.trunc,
        return_seg=not args.no_seg, render_params=rp, platforms=platforms,
    )
    print(f"wrote {args.outdir}: {meta}")

    if args.check:
        del G
        z = torch.randn(args.batch, meta["z_dim"], generator=torch.Generator().manual_seed(0))
        c = torch.as_tensor(CANONICAL_POSE_25)[None].expand(args.batch, -1)
        for platform in meta["platforms"]:
            art = load_artifact(args.outdir, device=platform)
            out = art.render(art.map_z(z.to(platform), c.to(platform)), c.to(platform))
            img = out[0] if meta["return_seg"] else out
            finite = bool(torch.isfinite(img).all())
            print(f"check ({platform}): rendered {tuple(img.shape)}, finite={finite}")
            if not finite:
                return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
