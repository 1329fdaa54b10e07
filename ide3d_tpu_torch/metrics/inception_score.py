"""Inception Score (contract: metrics/inception_score.py:18-41); the port's
copy of ide3d_tpu/metrics/inception_score.py.

IS needs class logits; with a generic detector the features are softmaxed.
With real Inception weights, pass a detector whose output is the 1008-way
logit head."""

from __future__ import annotations

import numpy as np

from .metric_utils import MetricOptions, compute_feature_stats_for_generator


def compute_is(opts: MetricOptions, num_splits: int = 10):
    feats = compute_feature_stats_for_generator(
        opts, capture_all=True, capture_mean_cov=False
    ).get_all()
    x = feats - feats.max(axis=1, keepdims=True)  # softmax over the feature axis
    probs = np.exp(x) / np.exp(x).sum(axis=1, keepdims=True)

    scores = []
    for i in range(num_splits):
        part = probs[i * len(probs) // num_splits : (i + 1) * len(probs) // num_splits]
        kl = part * (np.log(part + 1e-12) - np.log(part.mean(axis=0, keepdims=True) + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))
