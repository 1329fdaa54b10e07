"""mfu.<cell kind>: the convolution and matrix-product FLOPs of the work the
window completed (counts/flops.py, from the configuration's sizes) over the
window's wall time and the card's dense bf16 peak, in %."""

from ..counts import flops


def read(name: str, ctx: dict):
    run, win, work = ctx["run"], ctx["win"], ctx["work"]
    done = flops.work_flops(run.config, work)
    if done == 0 or win.seconds <= 0 or not run.device.startswith("cuda"):
        return None
    return 100.0 * done / win.seconds / flops.PEAK_BF16
