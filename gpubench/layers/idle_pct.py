"""idle_pct.<cell kind>: the share of the traced stretch's wall time in which
no operation ran on the device (1 - the union of the device operations'
intervals over the stretch), in %."""


def read(name: str, ctx: dict):
    stats, win = ctx["trace"], ctx["win"]
    if stats is None or win.trace_s <= 0 or stats.busy_s <= 0:
        return None
    return 100.0 * (1.0 - stats.busy_s / win.trace_s)
