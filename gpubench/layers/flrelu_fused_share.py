"""flrelu_fused_share.<cell kind>: the fused filtered_lrelu kernel's launches
in the traced stretch over the `G.sg3` spans times the stack's calls (9 at
the flagship's sizes). 1 where every call of the stack ran the kernel; less
where some call did not launch it."""

from ._sg3 import KERNEL, calls, stacks


def read(name: str, ctx: dict):
    found = stacks(ctx)
    if found is None:
        return None
    launches, _ = ctx["trace"].kernel_time(KERNEL)
    return launches / (len(found[0]) * calls(ctx))
