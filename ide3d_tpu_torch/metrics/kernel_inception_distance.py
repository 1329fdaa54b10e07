"""KID: polynomial-kernel MMD on detector features
(contract: metrics/kernel_inception_distance.py:18-46); the port's copy of
ide3d_tpu/metrics/kernel_inception_distance.py."""

from __future__ import annotations

import numpy as np

from .metric_utils import MetricOptions, compute_feature_stats_for_dataset, \
    compute_feature_stats_for_generator


def compute_kid(opts: MetricOptions, num_subsets: int = 100, max_subset_size: int = 1000) -> float:
    real = compute_feature_stats_for_dataset(opts, capture_all=True,
                                             capture_mean_cov=False).get_all()
    gen = compute_feature_stats_for_generator(opts, capture_all=True,
                                              capture_mean_cov=False).get_all()

    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    t = 0.0
    rs = np.random.RandomState(opts.seed)
    for _ in range(num_subsets):
        x = gen[rs.choice(gen.shape[0], m, replace=False)].astype(np.float64)
        y = real[rs.choice(real.shape[0], m, replace=False)].astype(np.float64)
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
