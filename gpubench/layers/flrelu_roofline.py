"""flrelu_roofline.<cell kind>: the fused filtered_lrelu kernel
(`csrc/filtered_lrelu.cu`) as a share of its bytes bound, in %: the bytes the
traced stacks must move (counts/sg3.launch_bytes: the stack's calls at the
batch of the kind's chunks, each input read once and each output written
once, times the `G.sg3` spans) over 3.35 TB/s, divided by the kernel's summed
device time. Read only where every call of those stacks ran the kernel
(flrelu_fused_share 1), so the bytes are those of the launches timed. The
op's FIR work bounds it tighter (about 2x the bytes' time), so a kernel at
that bound reads about half. Nothing without the span or the launches."""

from ..counts import k1, sg3
from ._sg3 import KERNEL, calls, stacks


def read(name: str, ctx: dict):
    found = stacks(ctx)
    if found is None:
        return None
    launches, total = ctx["trace"].kernel_time(KERNEL)
    n_stacks = len(found[0])
    if launches != n_stacks * calls(ctx) or total <= 0:
        return None
    bound_s = n_stacks * sum(sg3.launch_bytes(ctx["run"].config, ctx["work"]["sg3_batch"]))
    return 100.0 * bound_s / k1.HBM_BYTES_PER_S / total
