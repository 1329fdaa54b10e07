"""k1_bwd_roofline.<cell kind>: K1's backward (`sort_integrate_backward_kernel`)
as a share of its bound: the bytes it must move at the batch of the kind's K1
launches (its work's `k1_batch`; counts/k1.py) over 3.35 TB/s, divided by its
mean device time in the trace, in %."""

from ..counts import k1

KERNEL = r"\bsort_integrate_backward_kernel\b"


def read(name: str, ctx: dict):
    if ctx["trace"] is None:
        return None
    launches, total = ctx["trace"].kernel_time(KERNEL)
    if launches == 0:
        return None
    run = ctx["run"]
    bound_s = k1.backward_bytes(run.config, ctx["work"]["k1_batch"]) / k1.HBM_BYTES_PER_S
    return 100.0 * bound_s / (total / launches)
