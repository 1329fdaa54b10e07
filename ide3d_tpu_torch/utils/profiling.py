"""Replica consistency across the ranks of a data-parallel group.

Counterpart of ide3d_tpu/utils/profiling.py's `check_replica_consistency`
(the reference's `check_ddp_consistency`, torch_utils/misc.py:183). The JAX
module's scopes, trace, step timer and NaN debugging have no wrapper here:
`torch.profiler.record_function`, `torch.profiler.profile`, CUDA events and
`torch.autograd.set_detect_anomaly` are called as they are.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Group


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def check_replica_consistency(group: Group, *modules: torch.nn.Module) -> bool:
    """Whether every parameter and buffer of `modules` equals rank 0's, bit for
    bit, on every rank (the reference's check_ddp_consistency): the bytes
    broadcast from rank 0 as one buffer and compared; the verdict is the same
    on every rank. A collective: every rank calls it."""
    mine = torch.cat([_bytes(t) for m in modules for t in (*m.parameters(), *m.buffers())])
    ref = group.broadcast_(mine.clone())
    differs = torch.tensor([0 if torch.equal(mine, ref) else 1], dtype=torch.int32,
                           device=mine.device)
    return int(group.all_reduce_(differs)) == 0
