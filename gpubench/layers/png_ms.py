"""png_ms.<cell kind>: the median over the traced requests that edit of the
total wall ms of their `web.png` spans (the PNG encode and base64)."""

from ._spans import edit_requests, inside, median, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    if not found:
        return None
    return median([sum(p.ms for p in inside(found, r, "web.png")) for r, _ in edit_requests(found)])
