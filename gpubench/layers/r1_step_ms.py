"""r1_step_ms.<cell kind>: the median host time of a train step with R1,
each ending in a synchronize (the traced run's timed cycle)."""

import statistics


def read(name: str, ctx: dict):
    times = getattr(ctx["state"], "r1_times", None)
    return statistics.median(times) if times else None
