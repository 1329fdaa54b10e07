"""wait_ms.<cell kind>: the wall ms of the `video.wait` spans (the host blocked
on a chunk's copy to the host) per `video.chunk` in the traced stretch."""

from ._spans import per_chunk


def read(name: str, ctx: dict):
    return per_chunk(ctx, "video.wait")
