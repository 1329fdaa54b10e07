"""Training statistics over device scalars.

Counterpart of ide3d_tpu/parallel/stats.py's `StatsAccumulator` (the
reference's training_stats Collector): each stat is kept as a (count, sum,
sum of squares) triple on the stats' device and added to without a readback.
`mean`, `std` and `as_dict` read the triples summed over the group's ranks
(one all-reduce for every stat, the counterpart of JAX `psum_dict`), so every
rank reads the global batch's statistics; they are collectives, called by
every rank. Only they copy to the host.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .mesh import Group


class StatsAccumulator:
    def __init__(self, group: Optional[Group] = None):
        self.group = group or Group()
        self._acc: Optional[Dict[str, torch.Tensor]] = None
        self._totals: Optional[Dict[str, list]] = None

    def update(self, stats: Dict[str, torch.Tensor]) -> None:
        """Add one step's stats, each a 0-d tensor (or a number)."""
        acc = self._acc if self._acc is not None else {}
        for name, t in stats.items():
            t = torch.as_tensor(t).detach().float()
            t = torch.stack([torch.ones_like(t), t, t.square()])
            acc[name] = acc[name] + t if name in acc else t
        self._acc = acc
        self._totals = None

    def _read(self, name: str):
        if self._totals is None:
            names = sorted(self._acc or {})
            stacked = self.group.all_reduce_(torch.stack([self._acc[n] for n in names]))
            self._totals = {n: [float(v) for v in row] for n, row in zip(names, stacked.cpu())}
        return self._totals[name]

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
        return {k: self.mean(k) for k in sorted(self._acc or {})}

    def reset(self) -> None:
        self._acc = None
        self._totals = None
