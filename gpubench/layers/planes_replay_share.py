"""planes_replay_share.<cell kind>: the share of the `G.planes` spans in the
traced stretch that hold a `G.planes.replay` span, the plane stage replayed
from a CUDA graph (`ide3d_tpu_torch.models.plane_graphs`). Nothing where the
program has no such graphs, or no `G.planes` span was traced."""

import importlib.util

from ._spans import Span, inside, named, traced

REPLAY = "G.planes.replay"


def replays(stats, found: list) -> list:
    """The trace's `G.planes.replay` host events as spans, each with the
    innermost program span that contains it as its parent."""
    out = []
    for start, dur, name in stats.host:
        if name != REPLAY:
            continue
        end = start + dur
        around = [s for s in found if s.start <= start and end <= s.end]
        out.append(Span(REPLAY, start, end, max(around, key=lambda s: s.start, default=None)))
    return out


def read(name: str, ctx: dict):
    found = traced(ctx)
    planes = named(found, "G.planes") if found else []
    if not planes or importlib.util.find_spec("ide3d_tpu_torch.models.plane_graphs") is None:
        return None
    found = found + replays(ctx["trace"], found)
    return sum(1 for p in planes if inside(found, p, REPLAY)) / len(planes)
