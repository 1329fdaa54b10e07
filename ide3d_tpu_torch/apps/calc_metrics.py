"""Metric evaluation CLI (counterpart of ide3d_tpu/apps/calc_metrics.py).

Usage:
    python -m ide3d_tpu_torch.apps.calc_metrics --network runs/x/snapshot-final \\
        --data path/to/imgs --metrics fid,kid --num-items 1000 \\
        [--detector inception --detector-weights x.pth] [--device cuda]

G comes from apps.common.load_generator (a snapshot directory or
random:<seed>[:preset]); the detector from metrics.features.make_detector.
Prints one JSON record per metric (and appends it to --run-dir). Scores from
random-init detectors track relative change only.

`--mesh-devices N` splits the feature extraction over N ranks (one card each
over NCCL, gloo with `--device cpu`; the JAX app's mesh, the reference's
NCCL ranks); 0 or 1 runs one rank, torchrun's world runs its own. Every rank
gathers the features in item order, so the records equal one rank's; rank 0
prints and writes them. `main` returns rank 0's records (None where it
started the ranks).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", required=True,
                    help="a snapshot directory or random:<seed>[:full|small|tiny]; another "
                         "preset raises (the JAX package builds the full G for it)")
    ap.add_argument("--data", default=None)
    ap.add_argument("--metrics", default="fid")
    ap.add_argument("--num-items", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--detector", choices=["pixel", "inception", "vgg16"], default="pixel")
    ap.add_argument("--detector-weights", default=None,
                    help="torch state_dict (.pth) for the chosen detector")
    ap.add_argument("--cache-dir", default=".metric_cache")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="split the extraction over N ranks (the reference's NCCL-rank feature "
                         "sharding, metric_utils.py:209-259); 0 = one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..parallel import mesh

    device_type = torch.device(args.device).type
    return mesh.launch(_calc, max(args.mesh_devices, 1), device_type, args)


def _calc(group, args):
    from ..metrics import calc_metric, make_detector
    from ..parallel import mesh
    from .common import load_generator

    G = load_generator(args.network, group.device)
    mesh.replicate(group, G)
    if args.detector == "pixel" and args.metrics != "ppl2_wend" and group.is_main:
        print("WARNING: pixel detector gives scores NOT comparable with "
              "Inception-based references; pass --detector inception "
              "--detector-weights for real numbers.")
    det = make_detector(args.detector, args.detector_weights, device=group.device)

    dataset = None
    if args.data:
        from ..data.dataset import ImageFolderDataset

        dataset = ImageFolderDataset(args.data, resolution=G.cfg.img_resolution)

    records = []
    for metric in args.metrics.split(","):
        rec = calc_metric(
            metric.strip(), run_dir=args.run_dir, G=G, dataset=dataset, detector=det,
            num_items=args.num_items, batch_size=args.batch, cache_dir=args.cache_dir,
            device=group.device, group=group,
        )
        if group.is_main:
            print(json.dumps(rec, default=float))
        records.append(rec)
    return records if group.is_main else None


if __name__ == "__main__":
    main()
