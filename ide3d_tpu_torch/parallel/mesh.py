"""Process groups and data-parallel placement: the port's whole distributed layer.

Counterpart of ide3d_tpu/parallel/mesh.py (which replaces the reference's DDP
for encoder training, NCCL for the metrics, the rank-sharded sampler and the
grad sync with one device mesh). Here one process drives one card, as
`torch.distributed` does it:

  * `Group` is the counterpart of the 1-D 'data' mesh: rank, world size, the
    rank's device and backend, and the collectives the port uses. NCCL on
    CUDA, gloo on the CPU: the backend follows the rank's device, and
    nothing switches it;
  * the world comes from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT) when it is set; otherwise `launch`
    runs a function on world-size ranks itself: in this process for one rank,
    through `torch.multiprocessing.spawn` and a file store for more. A world of
    one holds a real process group and runs the same collectives;
  * `shard_batch` gives rank r rows [r*b, (r+1)*b) of a global batch, as the
    JAX NamedSharding splits dim 0; `replicate` broadcasts rank 0's
    parameters and buffers; `all_reduce_grads` averages a phase's gradients as
    one flat fp32 buffer, as StyleGAN2-ADA's loop does; `prefetch_to_device`
    copies the next batches on a side CUDA stream from pinned memory;
  * `global_draws` / `draw`: inside a data-parallel step every random draw is
    made at the GLOBAL batch's shape from the same generator on every rank and
    sliced to the rank's rows, so a W-rank step draws what a 1-rank step of
    the global batch draws and the ranks' generators stay equal.

`Group()` (no backend) is a process without a process group, whose
collectives are identities and whose gradients are used as they are: what a
library call with no group runs. A CLI always runs under a real group, of
one rank or more.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import queue
import shutil
import tempfile
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Group:
    """One rank's view of the data-parallel group. `backend` None: no process
    group (a lone process); `pg` None with a backend: the default group."""

    rank: int = 0
    size: int = 1
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    pg: object = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        """Whether a process group stands behind this Group (of one rank or more)."""
        return self.backend is not None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks, in place."""
        if self.distributed:
            dist.all_reduce(t, group=self.pg)
        return t

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of a tensor of the same shape on every rank."""
        if not self.distributed:
            return t.detach()
        return self.all_reduce_(t.detach().clone()) / self.size

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' tensors (equal shapes) concatenated along `dim` in rank
        order, on every rank. Not differentiable: see `gather_rows`."""
        if not self.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.pg)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's tensor, in place on every rank."""
        if self.distributed:
            dist.broadcast(t, src=self._global(0), group=self.pg)
        return t

    def broadcast_object(self, obj):
        """Rank 0's picklable object on every rank (small objects: metadata)."""
        if not self.distributed:
            return obj
        box = [obj if self.is_main else None]
        dist.broadcast_object_list(box, src=self._global(0), group=self.pg, device=self.device)
        return box[0]

    def _global(self, rank: int) -> int:
        return rank if self.pg is None else dist.get_global_rank(self.pg, rank)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device_type: str, local_rank: int) -> torch.device:
    if device_type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank on local index {local_rank} but {torch.cuda.device_count()} "
                               f"CUDA devices are visible")
        torch.cuda.set_device(local_rank)
        return torch.device("cuda", local_rank)
    return torch.device(device_type)


def torchrun_env() -> bool:
    """Whether torchrun (or another launcher) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def create_group(device_type: str = "cuda", rank: int = 0, world_size: int = 1, init_method: Optional[str] = None,
                 members: Optional[int] = None) -> Optional[Group]:
    """Initialise the default process group and return this rank's Group
    (the JAX `create_mesh`). Under torchrun the rank, world and local rank
    come from its environment; otherwise from the arguments and
    `init_method` (a `file://` store). A rank's device is `cuda:<local rank>`
    for device_type 'cuda', else the CPU; its backend NCCL on CUDA, gloo on
    the CPU. `members`: only ranks [0, members)
    form the group; the others get None and leave (the largest world that
    divides the batch)."""
    local_rank = rank
    if torchrun_env():
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    device = _rank_device(device_type, local_rank)
    backend = _backend_for(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    pg = None
    n = world_size if members is None else members
    if n < world_size:
        pg = dist.new_group(list(range(n)))
        if rank >= n:
            dist.destroy_process_group()
            return None
    return Group(rank=rank, size=n, device=device, backend=backend, pg=pg)


def destroy_group(group: Optional[Group]) -> None:
    if group is not None and group.distributed and dist.is_initialized():
        dist.destroy_process_group()


def _spawn_entry(index: int, fn: Callable, world_size: int, device_type: str,
                 init_method: str, args: tuple) -> None:
    group = create_group(device_type, index, world_size, init_method)
    try:
        fn(group, *args)
    finally:
        destroy_group(group)


def launch(fn: Callable, world_size: int, device_type: str = "cuda", *args):
    """Run fn(group, *args) on every rank of a group of `world_size` and
    return this process's result (None from a process that spawned ranks or
    a rank outside the group). Under torchrun this process is one rank of
    the launcher's world, and its first `world_size` ranks form the group.
    Otherwise one rank runs here, and more are started with
    torch.multiprocessing.spawn (fn must then be importable); a rank that
    fails fails the launch."""
    if torchrun_env():
        group = create_group(device_type, members=world_size)
        if group is None:
            return None
        try:
            return fn(group, *args)
        finally:
            destroy_group(group)
    store = tempfile.mkdtemp(prefix="ide3d_group_")
    init_method = "file://" + os.path.join(store, "store")
    try:
        if world_size == 1:
            group = create_group(device_type, 0, 1, init_method)
            try:
                return fn(group, *args)
            finally:
                destroy_group(group)
        import torch.multiprocessing as mp

        mp.spawn(_spawn_entry, args=(fn, world_size, device_type, init_method, args),
                 nprocs=world_size, join=True)
        return None
    finally:
        shutil.rmtree(store, ignore_errors=True)


def visible_world(device_type: str) -> int:
    """Every visible card (the launcher's world under torchrun; one process
    on the CPU): what the JAX apps' mesh spans by default."""
    if torchrun_env():
        return int(os.environ["WORLD_SIZE"])
    return max(torch.cuda.device_count(), 1) if device_type == "cuda" else 1


def dp_world(batch: int, device_type: str) -> int:
    """The JAX training apps' rule: the visible world, reduced until it
    divides the global batch."""
    n = visible_world(device_type)
    while batch % n:
        n -= 1
    return n


def local_batch_size(global_batch: int, group: Group) -> int:
    if global_batch % group.size:
        raise ValueError(f"{global_batch} rows (batch, chunk or rays) not divisible by the "
                         f"world size {group.size}")
    return global_batch // group.size


def rows(group: Group, n: int) -> slice:
    """Rank r's rows [r*b, (r+1)*b) of a global dim 0 of n."""
    b = local_batch_size(n, group)
    return slice(group.rank * b, (group.rank + 1) * b)


def shard_batch(group: Group, batch: dict) -> dict:
    """This rank's contiguous slice of each array or tensor's dim 0."""
    return {k: v[rows(group, v.shape[0])] for k, v in batch.items()}


def _flat_by_dtype(tensors: list) -> dict:
    out = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def replicate(group: Group, *modules: torch.nn.Module) -> None:
    """Broadcast rank 0's parameters and buffers of each module to every rank,
    one flat buffer per dtype."""
    tensors = [t.data for m in modules for t in (*m.parameters(), *m.buffers())]
    for same in _flat_by_dtype(tensors).values():
        flat = group.broadcast_(torch.cat([t.reshape(-1) for t in same]))
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_tree(group: Group, tree):
    """Rank 0's nested dict / list of tensors and plain values (a loaded
    checkpoint) on every rank: the structure and plain values pickled, each
    tensor through the collective on the group's device."""
    tensors = []

    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(strip(v) for v in x)
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return ("__tensor__", len(tensors) - 1, tuple(x.shape), x.dtype)
        return x

    skeleton = group.broadcast_object(strip(tree) if group.is_main else None)
    got = []

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, tuple) and len(x) == 4 and x[0] == "__tensor__":
            t = (tensors[x[1]].to(group.device) if group.is_main
                 else torch.empty(x[2], dtype=x[3], device=group.device))
            got.append(t)
            return t
        if isinstance(x, (list, tuple)):
            return type(x)(fill(v) for v in x)
        return x

    out = fill(skeleton)
    for t in got:
        group.broadcast_(t)
    return out


def all_reduce_grads(group: Group, params: list, grads) -> list:
    """The mean over ranks of each parameter's gradient (None: zeros), reduced
    as ONE flat fp32 buffer; returned as tensors shaped and typed as params.
    Without a process group the gradients are returned as they are."""
    if not group.distributed:
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1).float()
                      for p, g in zip(params, grads)])
    group.all_reduce_(flat)
    flat /= group.size
    out, offset = [], 0
    for p in params:
        out.append(flat[offset:offset + p.numel()].view_as(p).to(p.dtype))
        offset += p.numel()
    return out


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0; its backward sums the cotangents of every rank
    and keeps this rank's rows (a reduce-scatter), itself differentiable."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x, dim=0)

    @staticmethod
    def backward(ctx, g):
        return _ReduceScatterRows.apply(g, ctx.group), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, group):
        ctx.group = group
        return group.all_reduce_(g.detach().clone())[rows(group, g.shape[0])]

    @staticmethod
    def backward(ctx, v):
        return _GatherRows.apply(v, ctx.group), None


def gather_rows(group: Group, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x in rank order, differentiable to any order
    (R1 differentiates the discriminator's minibatch stddev twice)."""
    return _GatherRows.apply(x, group)


# ----------------------------------------------------------------- draws

_DRAW_ROWS = contextvars.ContextVar("ide3d_draw_rows", default=(0, 1))


@contextlib.contextmanager
def global_draws(group: Group):
    """Inside, `draw` makes each draw at the global batch's shape (dim 0 times
    the world size) and keeps this rank's rows."""
    token = _DRAW_ROWS.set((group.rank, group.size))
    try:
        yield
    finally:
        _DRAW_ROWS.reset(token)


def draw(fn: Callable, shape, **kw) -> torch.Tensor:
    """fn(shape, **kw) (torch.rand, torch.randn, a partial of torch.randint)
    for a batch-major shape; under `global_draws`, this rank's rows of the
    draw at the global shape."""
    rank, size = _DRAW_ROWS.get()
    shape = tuple(shape)
    full = fn((shape[0] * size,) + shape[1:], **kw)
    return full[rank * shape[0]:(rank + 1) * shape[0]]


# -------------------------------------------------------------- prefetch

PREFETCH_DEPTH = 2  # batches copied ahead of the step


def prefetch_to_device(loader: Iterable[dict], device) -> Iterator[dict]:
    """Wrap a host batch iterator (numpy dicts) so that the copy to the card
    overlaps the running step: a worker thread pins each batch and copies it
    on a side CUDA stream, PREFETCH_DEPTH batches ahead; the consumer's
    stream waits on the copy's event. On the CPU the batches are only made
    tensors. The generator ends when the loader does; the loader's exceptions
    re-raise in the consumer; closing the generator stops the worker."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
    stop = threading.Event()
    end = object()  # put after the loader's last batch

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
            for batch in loader:
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if stream is None:
                    item = (host, None)
                else:
                    with torch.cuda.stream(stream):
                        dev = {k: v.pin_memory().to(device, non_blocking=True)
                               for k, v in host.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    item = (dev, ready)
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # re-raised on the consumer's thread
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ready)
                for t in batch.values():
                    t.record_stream(cur)  # allocated on the side stream, used on this one
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
