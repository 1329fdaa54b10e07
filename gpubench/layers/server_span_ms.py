"""server_span_ms.<cell kind>: the median over the traced requests that edit
of the `web.request` span's wall ms less that of its `painter.edit` span: the
web layer's host work (JSON, mask decode, class-id lookup, PNG encode, base64)."""

from ._spans import edit_requests, median, traced


def read(name: str, ctx: dict):
    found = traced(ctx)
    if not found:
        return None
    return median([r.ms - sum(e.ms for e in edits) for r, edits in edit_requests(found)])
