"""to_host_ms.<cell kind>: the median wall ms of the `painter.to_host` spans
(the uint8 image and coloured seg copied to the host, waiting on the device)."""

from ._spans import median, named, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    return median([s.ms for s in named(found, "painter.to_host")]) if found else None
