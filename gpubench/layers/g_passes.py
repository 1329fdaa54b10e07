"""g_passes.<cell kind>: the `G.render` spans inside `painter.edit` spans over
the number of `painter.edit` spans: G passes a request, 2 uncached and 1 where
the frame cache holds the first pass."""

from ._spans import inside, named, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    edits = named(found, "painter.edit") if found else []
    if not edits:
        return None
    return sum(len(inside(found, e, "G.render")) for e in edits) / len(edits)
