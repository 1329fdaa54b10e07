"""The program's spans in a traced run, for the readers of the span metrics.

`ide3d_tpu_torch.utils.profiling.span` enters `torch.profiler.record_function`
while the profiler records, so each span is a `user_annotation` among the
trace's host operations (`TraceStats.host`), on the clock of the device's
events. Here they are kept by name and each is given its parent: the
innermost program span that contains it. Off CUDA the readers report nothing.
"""

from __future__ import annotations

import statistics
from typing import Optional

NAMES = frozenset({
    "G.planes", "G.render", "G.finish",
    "video.chunk", "video.wait", "video.tiles",
    "web.request", "web.png",
    "painter.edit", "painter.encode", "painter.to_host",
    "gan.step", "gan.g_phase", "gan.d_phase", "gan.r1",
})


class Span:
    __slots__ = ("name", "start", "end", "parent")

    def __init__(self, name: str, start: float, end: float, parent: Optional["Span"]):
        self.name, self.start, self.end, self.parent = name, start, end, parent

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e3

    def within(self, outer: "Span") -> bool:
        """Whether `outer` is one of this span's ancestors."""
        p = self.parent
        while p is not None and p is not outer:
            p = p.parent
        return p is outer


def spans(stats) -> list:
    """The program's spans of a `TraceStats` by start (the outer first where
    two start together), each with its parent found by containment."""
    out, open_ = [], []
    for start, dur, name in sorted((h for h in stats.host if h[2] in NAMES),
                                   key=lambda h: (h[0], -h[1])):
        end = start + dur
        while open_ and (start >= open_[-1].end or end > open_[-1].end):
            open_.pop()
        s = Span(name, start, end, open_[-1] if open_ else None)
        open_.append(s)
        out.append(s)
    return out


def traced(ctx) -> Optional[list]:
    """The spans of a traced run on the card; None elsewhere."""
    if ctx["trace"] is None or not ctx["run"].device.startswith("cuda"):
        return None
    return spans(ctx["trace"])


def named(found: list, name: str) -> list:
    return [s for s in found if s.name == name]


def inside(found: list, outer: Span, name: str) -> list:
    """The spans called `name` that `outer` contains, at any depth."""
    return [s for s in found if s.name == name and s.within(outer)]


def median(values: list) -> Optional[float]:
    return statistics.median(values) if values else None


def per_chunk(ctx, name: str) -> Optional[float]:
    """The wall ms of the spans called `name` over the number of video chunks."""
    found = traced(ctx)
    if not found:
        return None
    chunks = named(found, "video.chunk")
    return sum(s.ms for s in named(found, name)) / len(chunks) if chunks else None


def edit_requests(found: list) -> list:
    """(request, its `painter.edit` spans) of each request that edits."""
    out = [(r, inside(found, r, "painter.edit")) for r in named(found, "web.request")]
    return [(r, edits) for r, edits in out if edits]


def steps(found: list, r1: bool) -> list:
    """The `gan.step` spans that hold a `gan.r1` span (`r1`) or do not."""
    return [s for s in named(found, "gan.step") if bool(inside(found, s, "gan.r1")) == r1]


def plain_phase(ctx, name: str) -> Optional[float]:
    """The median wall ms of the spans called `name` in the steps without R1."""
    found = traced(ctx)
    if not found:
        return None
    return median([p.ms for s in steps(found, r1=False) for p in inside(found, s, name)])
