"""Where the time of the metrics' generator extraction goes, on one CUDA card.

    python3 tools/profile_torch_metrics.py [--batches 8] [--out out]

The flagship GeneratorConfig() (bf16, init(seed=0)) and the Inception
detector (the JAX package's deterministic init) at batch 8, as
compute_feature_stats_for_generator runs them, labels drawn from a dataset of
64 random labelled 512² PNGs (written to a temporary directory). Prints:
  * one batch split into its parts (median over --batches): the label draw
    (host clock, dataset.get_label), G (CUDA events), the detector (CUDA
    events) and the features' copy to the host,
  * the extraction loop's images/s over 64 items with labels from the
    dataset and with the canonical pose (no dataset, no decode),
  * the kernels by device time over 4 batches of the loop (torch.profiler)
    and the device's busy share of that window; the full table goes to
    <out>/profile_metrics.txt.
TF32 stays at PyTorch's defaults (cuDNN on, matmul off), as a calc_metrics
process runs. Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import write_dataset  # noqa: E402
from ide3d_tpu_torch.data.dataset import ImageFolderDataset  # noqa: E402
from ide3d_tpu_torch.metrics import make_detector  # noqa: E402
from ide3d_tpu_torch.metrics.metric_utils import (  # noqa: E402
    MetricOptions, compute_feature_stats_for_generator, sample_labels)
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator  # noqa: E402

B = 8


def split_batch(opts, rs) -> dict:
    """One extraction batch, part by part (ms)."""
    G, det = opts.G, opts.detector
    t0 = time.perf_counter()
    z = torch.as_tensor(rs.randn(B, G.cfg.z_dim), dtype=torch.float32, device="cuda")
    c = torch.as_tensor(sample_labels(opts, rs, B), device="cuda")
    labels_ms = (time.perf_counter() - t0) * 1e3
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    img = G(z, c).float()
    ev[1].record()
    feats = det(img)
    ev[2].record()
    t1 = time.perf_counter()
    feats.cpu()
    copy_ms = (time.perf_counter() - t1) * 1e3  # waits for G and the detector to finish
    return {"labels (host)": labels_ms, "G": ev[0].elapsed_time(ev[1]),
            "detector": ev[1].elapsed_time(ev[2]), "copy to host (host, incl. wait)": copy_ms}


def loop_rate(opts, n: int) -> float:
    """images/s of compute_feature_stats_for_generator over n items."""
    opts.num_items = n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_feature_stats_for_generator(opts, capture_all=True, capture_mean_cov=False)
    return n / (time.perf_counter() - t0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_metrics: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"TF32: cuDNN {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    G = Ide3dGenerator(GeneratorConfig()).init(seed=0).to("cuda").eval()
    det = make_detector("inception", device="cuda")
    with tempfile.TemporaryDirectory() as root, torch.inference_mode():
        imgs, _ = write_dataset(root, 64, 512)
        ds = ImageFolderDataset(imgs, resolution=512)
        opts = MetricOptions(G=G, dataset=ds, detector=det, batch_size=B, device="cuda")
        rs = np.random.RandomState(0)
        split_batch(opts, rs)  # warm-up: cuDNN plans, allocator
        parts = [split_batch(opts, rs) for _ in range(args.batches)]
        print(f"one batch of {B} (median of {args.batches}): " + ", ".join(
            f"{k} {statistics.median(p[k] for p in parts):.3f} ms" for k in parts[0]))
        with_ds = loop_rate(opts, 64)
        no_ds = loop_rate(MetricOptions(G=G, detector=det, batch_size=B, device="cuda"), 64)
        print(f"extraction loop, 64 items: {with_ds:.2f} images/s with labels from the dataset, "
              f"{no_ds:.2f} images/s at the canonical pose (no dataset reads)")

        from torch.profiler import ProfilerActivity, profile

        opts.num_items = 4 * B
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            compute_feature_stats_for_generator(opts, capture_all=True, capture_mean_cov=False)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation]  # a span's device row is no kernel
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profiler, 4 batches of the loop: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * dev_ms / wall_ms:.1f}%); top kernels by device time:")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:15]:
        print(f"  {e.self_device_time_total / 1e3 / 4:9.3f} ms/batch  x{math.ceil(e.count / 4):4d}  "
              f"{e.key[:100]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_metrics.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=80))


if __name__ == "__main__":
    main()
