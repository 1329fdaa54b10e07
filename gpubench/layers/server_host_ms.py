"""server_host_ms.<cell kind>: the median of a request's `handle` wall time
less its `PainterSession.edit` time: the web layer's host work (JSON, mask
decode, class-id lookup, PNG encode, base64)."""

from ..kinds.painter import session_medians


def read(name: str, ctx: dict):
    return session_medians(ctx["state"])[1]
