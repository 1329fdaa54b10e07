"""Metric evaluation CLI (counterpart of ide3d_tpu/apps/calc_metrics.py).

Usage:
    python -m ide3d_tpu_torch.apps.calc_metrics --network runs/x/snapshot-final \\
        --data path/to/imgs --metrics fid,kid --num-items 1000 \\
        [--detector inception --detector-weights x.pth] [--device cuda]

G comes from apps.common.load_generator (a snapshot directory or
random:<seed>[:preset]); the detector from metrics.features.make_detector.
Prints one JSON record per metric (and appends it to --run-dir). Scores from
random-init detectors track relative change only.
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
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..metrics import calc_metric, make_detector
    from .common import load_generator

    G = load_generator(args.network, args.device)
    if args.detector == "pixel" and args.metrics != "ppl2_wend":
        print("WARNING: pixel detector gives scores NOT comparable with "
              "Inception-based references; pass --detector inception "
              "--detector-weights for real numbers.")
    det = make_detector(args.detector, args.detector_weights, device=args.device)

    dataset = None
    if args.data:
        from ..data.dataset import ImageFolderDataset

        dataset = ImageFolderDataset(args.data, resolution=G.cfg.img_resolution)

    records = []
    for metric in args.metrics.split(","):
        rec = calc_metric(
            metric.strip(), run_dir=args.run_dir, G=G, dataset=dataset, detector=det,
            num_items=args.num_items, batch_size=args.batch, cache_dir=args.cache_dir,
            device=args.device,
        )
        print(json.dumps(rec, default=float))
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
