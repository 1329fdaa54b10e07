"""step_span_ms.<cell kind>: the median wall ms of the `gan.step` spans that
hold no `gan.r1` span, in the traced stretch (no synchronize ends a step)."""

from ._spans import median, steps, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    return median([s.ms for s in steps(found, r1=False)]) if found else None
