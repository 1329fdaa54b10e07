"""session_ms.<cell kind>: the median wall time of `PainterSession.edit`
over the window's requests (timed from the benchmark's side)."""

from ..kinds.painter import session_medians


def read(name: str, ctx: dict):
    return session_medians(ctx["state"])[0]
