"""finish_ms.<cell kind>: the wall ms of the `G.finish` spans (the raw head,
superres and the seg upsample) per `video.chunk` in the traced stretch."""

from ._spans import per_chunk


def read(name: str, ctx: dict):
    return per_chunk(ctx, "G.finish")
