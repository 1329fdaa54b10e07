"""edit_span_ms.<cell kind>: the median wall ms of the `painter.edit` spans
(`PainterSession.edit`) in the traced stretch."""

from ._spans import median, named, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    return median([s.ms for s in named(found, "painter.edit")]) if found else None
