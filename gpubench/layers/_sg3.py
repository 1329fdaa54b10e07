"""What the SG3 stack's readers share: its `G.sg3` spans (a span that
layers/_spans.py does not keep by name) and its fused filtered_lrelu launches
in a traced run on the card. Nothing where the program has no such span or
kernel (the parent of the SG3 kernel, whose stack runs the plain op)."""

from __future__ import annotations

from ..counts import sg3 as counts
from ._spans import named, traced

SPAN = "G.sg3"
KERNEL = r"\bfiltered_lrelu(_act)?_kernel\b"


def stacks(ctx):
    """(the `G.sg3` spans' wall ms, the number of `video.chunk` spans), or
    None off the card or where no `G.sg3` span was traced."""
    found = traced(ctx)
    ms = [dur / 1e3 for _, dur, name in ctx["trace"].host if name == SPAN] if found is not None else []
    if not ms:
        return None
    return ms, len(named(found, "video.chunk"))


def calls(ctx) -> int:
    """The stack's filtered_lrelu calls a frame batch (its layers and ToRGB)."""
    return len(counts.specs(ctx["run"].config))
