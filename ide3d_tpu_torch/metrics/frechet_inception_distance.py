"""FID (contract: metrics/frechet_inception_distance.py:20-41); the port's copy
of ide3d_tpu/metrics/frechet_inception_distance.py."""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .metric_utils import MetricOptions, compute_feature_stats_for_dataset, \
    compute_feature_stats_for_generator


def compute_fid(opts: MetricOptions) -> float:
    stats_real = compute_feature_stats_for_dataset(opts, capture_mean_cov=True)
    stats_gen = compute_feature_stats_for_generator(opts, capture_mean_cov=True)

    mu_real, sigma_real = stats_real.get_mean_cov()
    mu_gen, sigma_gen = stats_gen.get_mean_cov()

    m = np.square(mu_gen - mu_real).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    fid = np.real(m + np.trace(sigma_gen + sigma_real - s * 2))
    return float(fid)
