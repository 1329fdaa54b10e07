"""Training statistics over device scalars.

Counterpart of ide3d_tpu/parallel/stats.py's `StatsAccumulator` (the
reference's training_stats Collector): each stat is kept as a (count, sum,
sum of squares) triple on the stats' device and added to without a readback;
only `mean`, `std` and `as_dict` copy to the host. One process, one card: no
cross-device reduction.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


class StatsAccumulator:
    def __init__(self):
        self._acc: Optional[Dict[str, torch.Tensor]] = None

    def update(self, stats: Dict[str, torch.Tensor]) -> None:
        """Add one step's stats, each a 0-d tensor (or a number)."""
        acc = self._acc if self._acc is not None else {}
        for name, t in stats.items():
            t = torch.as_tensor(t).detach().float()
            t = torch.stack([torch.ones_like(t), t, t.square()])
            acc[name] = acc[name] + t if name in acc else t
        self._acc = acc

    def _read(self, name: str):
        return [float(v) for v in self._acc[name].cpu()]

    def mean(self, name: str) -> float:
        c, s, _ = self._read(name)
        return s / max(c, 1.0)

    def std(self, name: str) -> float:
        c, s, ss = self._read(name)
        if c < 1:
            return 0.0
        m = s / c
        return math.sqrt(max(ss / c - m * m, 0.0))

    def as_dict(self) -> Dict[str, float]:
        return {k: self.mean(k) for k in (self._acc or {})}

    def reset(self) -> None:
        self._acc = None
