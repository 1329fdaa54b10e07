"""step_ms.<cell kind>: the median host time of a train step without R1,
each ending in a synchronize (the traced run's timed cycle)."""

import statistics


def read(name: str, ctx: dict):
    times = getattr(ctx["state"], "step_times", None)
    return statistics.median(times) if times else None
