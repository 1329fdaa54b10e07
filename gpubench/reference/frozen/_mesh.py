"""The data-parallel helpers of `parallel/mesh.py` for one process."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Group:
    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None

    @property
    def is_main(self) -> bool:
        return True

    @property
    def distributed(self) -> bool:
        return False

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach()


def rows(group: Group, n: int) -> slice:
    return slice(0, n)


def gather_rows(group: Group, x: torch.Tensor) -> torch.Tensor:
    return x


def all_reduce_grads(group: Group, params: list, grads) -> list:
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


@contextlib.contextmanager
def global_draws(group: Group):
    yield


def draw(fn: Callable, shape, **kw) -> torch.Tensor:
    return fn(tuple(shape), **kw)
