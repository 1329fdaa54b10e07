"""Feature statistics for the metric suite.

Counterpart of ide3d_tpu/metrics/metric_utils.py: `FeatureStats` (a raw
feature bank and running moments, numpy), `MetricOptions`, the disk cache of
the dataset's statistics, and the two extraction loops. The generator side
draws z and c from `np.random.RandomState(opts.seed)` exactly as the JAX
package does, runs G at batch `opts.batch_size` on `opts.device`, and hands the
fp32 image to the detector; features come back to the host as numpy.

Under a data-parallel `opts.group` (the JAX `mesh`, the reference's NCCL
ranks) both loops split each batch of items over the ranks (contiguous rows;
a short last batch as evenly as it goes) and gather the features in item
order on every rank, so every rank holds the 1-rank bank and computes the
same metric; the dataset cache is read when rank 0 finds it and written by
rank 0. The batch of generated items must divide by the world size.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import Group, rows


class FeatureStats:
    """Raw feature bank + running moments (contract: metric_utils.py:97-162)."""

    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is None:
            self.num_features = num_features
            self.raw_mean = np.zeros(num_features, np.float64)
            self.raw_cov = np.zeros((num_features, num_features), np.float64)
        elif num_features != self.num_features:
            raise ValueError(f"{num_features} features, the bank holds {self.num_features}")

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be [N, dim], got {x.shape}")
        if self.max_items is not None and self.num_items + x.shape[0] > self.max_items:
            if self.is_full():
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    # ------------------------------------------------------------------- cache

    def save(self, path: str):
        with open(path, "wb") as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, path: str) -> "FeatureStats":
        """Read a file that `save` wrote (a pickle: only this program's own cache)."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = cls()
        obj.__dict__.update(state)
        return obj


@dataclasses.dataclass
class MetricOptions:
    """Everything a metric needs (the reference's MetricOptions,
    metric_utils.py:23-40). G and the detector are modules that hold their
    weights; both must live on `device`."""

    G: object = None  # Ide3dGenerator
    dataset: object = None  # indexable -> (img uint8 HWC, [seg], label); get_label(i)
    detector: object = None  # a features.make_detector module
    num_items: int = 1000
    # Real-side item cap (reference max_real, metric_main.py:86-148): -1 =
    # follow num_items, None = the full dataset, int = an explicit cap.
    max_real: Optional[int] = -1
    batch_size: int = 8
    cache_dir: Optional[str] = None
    seed: int = 0
    # conditional-render evaluation (reference metric_utils.py:70-81): G renders
    # the dataset's images through its built-in encoder (GeneratorConfig.use_encoder).
    cond_render: bool = False
    device: torch.device | str = "cuda"
    group: Optional[Group] = None  # split the extraction over its ranks


def _cache_path(opts: MetricOptions, tag: str,
                capture_all: bool, capture_mean_cov: bool) -> Optional[str]:
    if opts.cache_dir is None:
        return None
    # The capture flags are part of the key: a mean/cov-only entry (FID)
    # cannot serve a raw-feature-bank consumer (KID/PR).
    n_key = _resolved_max_real(opts) if tag == "dataset" else opts.num_items
    key = (f"{tag}-{type(opts.detector).__name__}-{n_key}"
           f"-{int(capture_all)}{int(capture_mean_cov)}")
    # The detector's weights too: one class under a random init and under a
    # weights file gives other features of the same data.
    prov = getattr(opts.detector, "provenance", None)
    if prov is not None:
        key += f"-{prov['source']}-{prov['weights']}"
    if opts.dataset is not None:
        # The dataset's identity too: the same path loaded with another xflip,
        # resolution or length has other real statistics (train_gan's metric
        # dataset pins xflip=False while the training loader mirrors).
        if hasattr(opts.dataset, "_path"):
            key += "-" + os.path.basename(str(opts.dataset._path))
        for attr in ("xflip", "resolution"):
            if hasattr(opts.dataset, attr):
                key += f"-{attr}{getattr(opts.dataset, attr)}"
        try:
            key += f"-n{len(opts.dataset)}"
        except TypeError:
            pass
    h = hashlib.md5(key.encode()).hexdigest()[:12]
    os.makedirs(opts.cache_dir, exist_ok=True)
    return os.path.join(opts.cache_dir, f"stats-{h}.pkl")


def _resolved_max_real(opts: MetricOptions) -> Optional[int]:
    """Real-side item cap: the reference's max_real semantics
    (metrics/metric_utils.py:216, metric_main.py:86-148)."""
    if opts.max_real == -1:
        return opts.num_items
    return opts.max_real  # None = full dataset


def _gather_items(group, feats: torch.Tensor, counts: list) -> np.ndarray:
    """Every rank's features [counts[rank], dim] in rank (item) order, on every
    rank: padded to the largest count for the collective, then trimmed."""
    m = max(counts)
    pad = torch.zeros((m - feats.shape[0],) + tuple(feats.shape[1:]), dtype=feats.dtype,
                      device=feats.device)
    full = group.all_gather(torch.cat([feats, pad])).cpu().numpy()
    return np.concatenate([full[r * m:r * m + c] for r, c in enumerate(counts)])


def _split(group, n: int) -> list:
    """Item counts of each rank for a batch of n items, as even as they go."""
    return [n // group.size + (1 if r < n % group.size else 0) for r in range(group.size)]


def compute_feature_stats_for_dataset(
    opts: MetricOptions, capture_all=False, capture_mean_cov=True
) -> FeatureStats:
    group = opts.group or Group()
    cache = _cache_path(opts, "dataset", capture_all, capture_mean_cov)
    if cache and group.broadcast_object(os.path.exists(cache)):
        return FeatureStats.load(cache)

    cap = _resolved_max_real(opts)
    stats = FeatureStats(capture_all, capture_mean_cov, max_items=cap)
    B = opts.batch_size
    n = len(opts.dataset) if cap is None else min(len(opts.dataset), cap)
    i = 0
    with torch.inference_mode():
        while not stats.is_full() and i < n:
            counts = _split(group, min(i + B, n) - i)
            lo, k = i + sum(counts[:group.rank]), counts[group.rank]
            # a rank with no item of a short last batch runs the batch's first
            # one to take part in the gather, and contributes none
            imgs = np.stack([opts.dataset[j][0] for j in (range(lo, lo + k) if k else [i])])
            x = torch.from_numpy(imgs).to(opts.device).float() / 127.5 - 1.0
            stats.append(_gather_items(group, opts.detector(x).float()[:k], counts))
            i += B

    if cache and group.is_main:
        stats.save(cache)
    return stats


def sample_labels(opts: MetricOptions, rs: np.random.RandomState, n: int) -> np.ndarray:
    """[n, 25] camera labels: drawn from the dataset's poses when it has them
    (one rs.randint draw, the same as the JAX package's), else the canonical
    pose (no draw). The labels come from `dataset.get_label`, as in the
    reference: reading the items (the JAX package takes item[-1]) decodes
    each drawn image (147 ms a batch of 8 at 512² on an H100 machine's host)."""
    from ..render.camera import CANONICAL_POSE_25

    if opts.dataset is not None and getattr(opts.dataset, "label_dim", 0) == 25:
        idx = rs.randint(len(opts.dataset), size=n)
        return np.stack([opts.dataset.get_label(int(i)) for i in idx]).astype(np.float32)
    return np.tile(np.asarray(CANONICAL_POSE_25, np.float32), (n, 1))


def compute_feature_stats_for_generator(
    opts: MetricOptions, capture_all=False, capture_mean_cov=True
) -> FeatureStats:
    G, dev = opts.G, opts.device
    if opts.cond_render:
        # G(z, c, cond_img=<a dataset image>): ws from G's encoder, rendered at
        # c; the condition images are a second draw of dataset indices.
        if opts.dataset is None:
            raise ValueError("cond_render needs a dataset")
        if not G.cfg.use_encoder:
            raise ValueError("cond_render requires GeneratorConfig.use_encoder")
    group = opts.group or Group()
    stats = FeatureStats(capture_all, capture_mean_cov, max_items=opts.num_items)
    rs = np.random.RandomState(opts.seed)
    B = opts.batch_size
    mine = rows(group, B)  # this rank's rows of each batch
    with torch.inference_mode():
        while not stats.is_full():
            z = torch.as_tensor(rs.randn(B, G.cfg.z_dim)[mine], dtype=torch.float32, device=dev)
            c = torch.as_tensor(sample_labels(opts, rs, B)[mine], device=dev)
            cond = None
            if opts.cond_render:
                idx = rs.randint(len(opts.dataset), size=B)[mine]
                cond = torch.from_numpy(np.stack([opts.dataset[int(i)][0] for i in idx])).to(dev)
                cond = cond.float() / 127.5 - 1.0
            img = G(z, c, cond_img=cond).float()
            stats.append(_gather_items(group, opts.detector(img).float(),
                                       [mine.stop - mine.start] * group.size))
    return stats
