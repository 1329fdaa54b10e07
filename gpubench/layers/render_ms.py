"""render_ms.<cell kind>: the wall ms of the `G.render` spans (the coarse and
fine passes, K1) per `video.chunk` in the traced stretch."""

from ._spans import per_chunk


def read(name: str, ctx: dict):
    return per_chunk(ctx, "G.render")
