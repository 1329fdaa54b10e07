"""r1_step_span_ms.<cell kind>: the median wall ms of the `gan.step` spans that
hold a `gan.r1` span, in the traced stretch."""

from ._spans import median, steps, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    return median([s.ms for s in steps(found, r1=True)]) if found else None
