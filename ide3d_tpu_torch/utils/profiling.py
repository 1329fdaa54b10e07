"""Spans on the profiler's own clock, and replica consistency across the ranks
of a data-parallel group.

`span(name)`, a context manager or a decorator, marks a stretch of the port's
host work: a G stage, a video chunk, a Painter request, a phase of the GAN step.
While a torch profiler records (`torch.profiler.profile`: the benchmark's
traced run, `tools/profile_torch_*.py`, an operator's own profile), the span
enters `torch.profiler.record_function(name)`, so it lands in the profiler's
trace as a `user_annotation` on the clock of the device's events, inside the
span that encloses it on its thread; the profiler keeps and writes it. While
nothing records, and while torch.compile or torch.export traces (an exported
program holds no profiler node), `span` checks one flag and returns a shared
no-op. Nothing is switched on: the spans are there whenever someone profiles.

Counterpart of ide3d_tpu/utils/profiling.py's `named_scope` and
`check_replica_consistency` (the reference's `check_ddp_consistency`,
torch_utils/misc.py:183). The JAX module's trace, step timer and NaN debugging
have no wrapper here: `torch.profiler.profile`, CUDA events and
`torch.autograd.set_detect_anomaly` are called as they are.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.mesh import Group

_PROFILER = torch.autograd.profiler  # its `_is_profiler_enabled` follows every profiler


class _NoSpan:
    """What `span` returns where nothing records, one shared object a name: a
    context that does nothing and, as a decorator, a function that asks `span`
    again at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


class _Span(torch.profiler.record_function):
    """A recorded span; as a decorator it asks `span` again at each call, as
    the no-op does, so that decorating under a profiler records nothing later."""

    __call__ = _NoSpan.__call__


_NO_SPANS: dict = {}


def span(name: str):
    """A span named `name` (see the module docstring): `with span(name):` or
    `@span(name)`."""
    if _PROFILER._is_profiler_enabled and not (torch.compiler.is_compiling()
                                               or torch.compiler.is_exporting()):
        return _Span(name)
    off = _NO_SPANS.get(name)
    if off is None:
        off = _NO_SPANS[name] = _NoSpan(name)
    return off


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
