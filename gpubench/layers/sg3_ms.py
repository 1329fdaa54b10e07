"""sg3_ms.<cell kind>: the wall ms of the `G.sg3` spans (the alias-free
superres stack, inside `G.finish`) per `video.chunk` in the traced stretch."""

from ._sg3 import stacks


def read(name: str, ctx: dict):
    found = stacks(ctx)
    if found is None or found[1] == 0:
        return None
    ms, chunks = found
    return sum(ms) / chunks
