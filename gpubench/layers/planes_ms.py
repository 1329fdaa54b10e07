"""planes_ms.<cell kind>: the wall ms of the `G.planes` spans (the vb stack,
the renderer's table, the feature volume) per `video.chunk` in the traced stretch."""

from ._spans import per_chunk


def read(name: str, ctx: dict):
    return per_chunk(ctx, "G.planes")
