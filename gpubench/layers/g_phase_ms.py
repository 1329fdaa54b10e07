"""g_phase_ms.<cell kind>: the median wall ms of the `gan.g_phase` spans of the
steps without R1 in the traced stretch."""

from ._spans import plain_phase


def read(name: str, ctx: dict):
    return plain_phase(ctx, "gan.g_phase")
