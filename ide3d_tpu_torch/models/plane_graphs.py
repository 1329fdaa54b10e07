"""G's plane stage replayed from a CUDA graph in inference.

The plane stage (`Ide3dSynthesisNetwork.plane_table`: the vb stack, the
renderer's table and, for the hybrid G, the feature volume) is a few hundred
small launches whose dispatch on the host, not the card, sets the pace of a
video chunk. Where the call shows that nothing but the values of `ws` can
differ from one call to the next (`engages`), the stage's launches are
captured once into a CUDA graph and replayed after that. No kernel changes:
the graph holds the same cuDNN, PyTorch and FIR launches as the eager stage.

A module keeps its graphs in a `Graphs` (a fresh one in every copy of the
module), one a key: the device, shape and dtype of `ws`, `noise_mode`,
whether inference mode is on, the TF32 and autocast settings, and the address
and dtype of every parameter and buffer the stage reads. A `.to()`, a
`load_state_dict(assign=True)` or a swapped tensor or module gives another
key, so a replay never reads freed memory; an in-place update (Adam, EMA)
keeps the addresses, and the replay reads the new values. The first call at a
key runs eager: it warms the stage and settles cuDNN's choices. The second
warms once more on a side stream and captures there, as `torch.cuda.graphs`
asks, then replays. A module's graphs share one memory pool, and at most
`MAX_KEYS` keys are kept (the oldest dropped). `ws` is copied into the graph's
static input and the outputs are cloned out of its static outputs, so a
returned table never aliases memory that the next replay writes: callers keep
tables across calls (the Painter's plane cache).

Counts since the last `reset_counts()`, as K1's launch counters:
`stage.captures` graphs captured, `stage.replays` calls served by a replay
(the capturing call included), `stage.eager` calls on CUDA that ran the
stage's operations eagerly (not engaged, or a key's first call).
"""

from __future__ import annotations

import collections
import threading
from typing import Optional

import torch

from ..utils.profiling import span

MAX_KEYS = 4  # keys kept a module, the oldest dropped


def engages(on_cuda: bool, grad_enabled: bool, noise_mode: str, tracing: bool,
            capturing: bool) -> bool:
    """Whether a call replays from a graph: `ws` on a CUDA device, no gradient
    wanted (no_grad or inference mode), no noise drawn, no torch.compile or
    torch.export trace, and the current stream not already capturing."""
    return (on_cuda and not grad_enabled and noise_mode in ("const", "none")
            and not tracing and not capturing)


def stage(S, ws: torch.Tensor, noise_mode: str = "const",
          generator: Optional[torch.Generator] = None) -> tuple:
    """`S.plane_stage(ws, noise_mode, generator)`, replayed from a graph where
    `engages` holds. S is an `Ide3dSynthesisNetwork`."""
    tracing = torch.compiler.is_compiling() or torch.compiler.is_exporting()
    on_cuda = ws.is_cuda
    capturing = on_cuda and not tracing and torch.cuda.is_current_stream_capturing()
    if not engages(on_cuda, torch.is_grad_enabled(), noise_mode, tracing, capturing):
        if on_cuda and not tracing:
            stage.eager += 1
        return S.plane_stage(ws, noise_mode, generator)
    graphs = S.__dict__.get("_plane_graphs")
    if graphs is None:
        graphs = S._plane_graphs = Graphs()
    return graphs.run(S, ws, noise_mode)


def reset_counts() -> None:
    stage.captures = stage.replays = stage.eager = 0


def counts() -> dict:
    return {"captures": stage.captures, "replays": stage.replays, "eager": stage.eager}


reset_counts()


def _addresses(m: torch.nn.Module, out: list) -> list:
    for group in (m._parameters, m._buffers):
        for t in group.values():
            if t is not None:
                out += (t.data_ptr(), t.dtype)
    for child in m._modules.values():
        if child is not None:
            _addresses(child, out)
    return out


def key(S, ws: torch.Tensor, noise_mode: str) -> tuple:
    """What a graph of S's plane stage is captured for (see the module docstring)."""
    addresses = []
    for m in S.plane_stage_modules():
        _addresses(m, addresses)
    return (ws.device, tuple(ws.shape), ws.dtype, noise_mode, torch.is_inference_mode_enabled(),
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.is_autocast_enabled("cuda"), tuple(addresses))


class _Graph:
    __slots__ = ("graph", "ws", "out")

    def __init__(self, graph: torch.cuda.CUDAGraph, ws: torch.Tensor, out: tuple):
        self.graph, self.ws, self.out = graph, ws, out


class Graphs:
    """One module's graphs of its plane stage by key; None for a key seen once."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.pool = None
        self.lock = threading.Lock()

    def __deepcopy__(self, memo) -> "Graphs":
        return Graphs()

    def run(self, S, ws: torch.Tensor, noise_mode: str) -> tuple:
        k = key(S, ws, noise_mode)
        with self.lock:
            if k not in self.entries:
                self.entries[k] = None
                if len(self.entries) > MAX_KEYS:
                    self.entries.popitem(last=False)
                stage.eager += 1
                return S.plane_stage(ws, noise_mode)
            self.entries.move_to_end(k)
            g = self.entries[k]
            if g is None:
                g = self.entries[k] = self._capture(S, ws, noise_mode)
                stage.captures += 1
            g.ws.copy_(ws)
            with span("G.planes.replay"):
                g.graph.replay()
            stage.replays += 1
            return tuple(None if t is None else t.clone() for t in g.out)

    def _capture(self, S, ws: torch.Tensor, noise_mode: str) -> _Graph:
        with torch.cuda.device(ws.device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            static = torch.empty(ws.shape, dtype=ws.dtype, device=ws.device).copy_(ws)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                S.plane_stage(static, noise_mode)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = S.plane_stage(static, noise_mode)
        return _Graph(graph, static, out)
