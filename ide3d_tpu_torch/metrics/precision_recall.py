"""Improved precision & recall via k-NN manifold estimation
(contract: metrics/precision_recall.py:36-72); the port's copy of
ide3d_tpu/metrics/precision_recall.py."""

from __future__ import annotations

import numpy as np

from .metric_utils import MetricOptions, compute_feature_stats_for_dataset, \
    compute_feature_stats_for_generator


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aa = np.square(a).sum(1)[:, None]
    bb = np.square(b).sum(1)[None, :]
    return np.maximum(aa + bb - 2 * a @ b.T, 0.0)


def _manifold_radii(feats: np.ndarray, nhood_size: int, batch: int = 4096) -> np.ndarray:
    radii = np.zeros(feats.shape[0], np.float64)
    for i in range(0, feats.shape[0], batch):
        d = _pairwise_sq_dists(feats[i : i + batch], feats)
        d.sort(axis=1)
        radii[i : i + batch] = d[:, nhood_size]  # k-th neighbor (0th is self)
    return radii


def _fraction_in_manifold(probes: np.ndarray, manifold: np.ndarray,
                          radii: np.ndarray, batch: int = 4096) -> float:
    hits = 0
    for i in range(0, probes.shape[0], batch):
        d = _pairwise_sq_dists(probes[i : i + batch], manifold)
        hits += int(np.any(d <= radii[None, :], axis=1).sum())
    return hits / probes.shape[0]


def compute_pr(opts: MetricOptions, nhood_size: int = 3):
    real = compute_feature_stats_for_dataset(opts, capture_all=True,
                                             capture_mean_cov=False).get_all().astype(np.float64)
    gen = compute_feature_stats_for_generator(opts, capture_all=True,
                                              capture_mean_cov=False).get_all().astype(np.float64)
    r_real = _manifold_radii(real, nhood_size)
    r_gen = _manifold_radii(gen, nhood_size)
    precision = _fraction_in_manifold(gen, real, r_real)
    recall = _fraction_in_manifold(real, gen, r_gen)
    return float(precision), float(recall)
