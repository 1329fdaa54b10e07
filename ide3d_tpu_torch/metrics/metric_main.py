"""Metric registry + dispatcher (contract: metrics/metric_main.py:29-148).

Counterpart of ide3d_tpu/metrics/metric_main.py, with the same names: fid,
kid, pr, ppl2_wend, eqt, eqr, inception_score (also registered as `is`), and
the reference's 50k presets with their num_items / max_real. Each call returns
one record (results, metric, total_time, num_items, detector provenance) and
appends it to `run_dir`/metric-<name>.jsonl when a run_dir is given (rank 0's,
under a data-parallel `group`, whose every rank computes the same record).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict

from .metric_utils import MetricOptions

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn: Callable) -> Callable:
    assert callable(fn)
    _metric_dict[fn.__name__] = fn
    return fn


def list_metrics():
    return list(_metric_dict.keys())


def is_valid_metric(name: str) -> bool:
    return name in _metric_dict


def calc_metric(metric: str, run_dir: str = None, **kwargs) -> dict:
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric!r}; have {list_metrics()}")
    opts = MetricOptions(**kwargs)
    t0 = time.time()
    results = _metric_dict[metric](opts)
    total_time = time.time() - t0

    record = {
        "results": results,
        "metric": metric,
        "total_time": total_time,
        "num_items": opts.num_items,
        # Scores from random-init detectors track relative change only; the
        # persisted record says which weights made them.
        "detector": getattr(opts.detector, "provenance",
                            {"detector": type(opts.detector).__name__,
                             "weights": None, "source": "unknown"}),
    }
    if run_dir is not None and (opts.group is None or opts.group.is_main):
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
    return record


# --------------------------------------------------------------------- registry


@register_metric
def fid(opts: MetricOptions):
    from .frechet_inception_distance import compute_fid

    return {"fid": compute_fid(opts)}


@register_metric
def kid(opts: MetricOptions):
    from .kernel_inception_distance import compute_kid

    return {"kid": compute_kid(opts)}


@register_metric
def pr(opts: MetricOptions):
    from .precision_recall import compute_pr

    precision, recall = compute_pr(opts)
    return {"precision": precision, "recall": recall}


@register_metric
def ppl2_wend(opts: MetricOptions):
    from .perceptual_path_length import compute_ppl

    return {"ppl2_wend": compute_ppl(opts)}


@register_metric
def eqt(opts: MetricOptions):
    from .equivariance import compute_eqt

    return {"eqt_psnr_db": compute_eqt(opts)}


@register_metric
def eqr(opts: MetricOptions):
    from .equivariance import compute_eqr

    return {"eqr_psnr_db": compute_eqr(opts)}


@register_metric
def inception_score(opts: MetricOptions):
    from .inception_score import compute_is

    mean, std = compute_is(opts)
    return {"is_mean": mean, "is_std": std}


_metric_dict["is"] = inception_score  # `is` is a keyword, so not a function name


# ------------------------------------------------- reference 50k-scale presets
# The reference's num_gen / max_real (metrics/metric_main.py:86-148):
# fid50k_full takes 50k generated items against the FULL dataset; kid and pr
# cap the real items at 1M and 200k.


@register_metric
def fid50k_full(opts: MetricOptions):
    from .frechet_inception_distance import compute_fid

    opts.num_items, opts.max_real = 50000, None
    return {"fid50k_full": compute_fid(opts)}


@register_metric
def kid50k_full(opts: MetricOptions):
    from .kernel_inception_distance import compute_kid

    opts.num_items, opts.max_real = 50000, 1000000
    return {"kid50k_full": compute_kid(opts)}


@register_metric
def pr50k3_full(opts: MetricOptions):
    from .precision_recall import compute_pr

    opts.num_items, opts.max_real = 50000, 200000
    precision, recall = compute_pr(opts, nhood_size=3)
    return {"pr50k3_full_precision": precision, "pr50k3_full_recall": recall}


@register_metric
def eqt50k_int(opts: MetricOptions):
    from .equivariance import compute_eqt

    opts.num_items = 50000
    return {"eqt50k_int_psnr_db": compute_eqt(opts, shift_px=8)}


@register_metric
def eqt50k_frac(opts: MetricOptions):
    from .equivariance import compute_eqt

    opts.num_items = 50000
    return {"eqt50k_frac_psnr_db": compute_eqt(opts, shift_px=1)}


@register_metric
def eqr50k(opts: MetricOptions):
    from .equivariance import compute_eqr

    opts.num_items = 50000
    return {"eqr50k_psnr_db": compute_eqr(opts)}


@register_metric
def is50k(opts: MetricOptions):
    from .inception_score import compute_is

    opts.num_items, opts.max_real = 50000, None
    mean, std = compute_is(opts)
    return {"is50k_mean": mean, "is50k_std": std}
