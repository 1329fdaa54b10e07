"""The work of a frame of the alias-free superres G, from the configuration's
sizes alone (2 FLOPs a multiply-add; the stack's schedule is the reference's,
reference/sg3.layer_specs).

`frame_flops`: the convolution and matrix-product FLOPs of a frame, as
flops.generator_frame counts them: its vb stack, decoder and raw head, and
the SG3 stack's style affines, modulated convolutions at full padding and
demodulation products in place of the SG2 superres. The filtered leaky
ReLU's FIR work is not counted there (CUDA-core work, as the sort and the
plane lookups are not).

`launch_bytes`: what one filtered_lrelu call must move, each input read once
and each output written once: the conv output and the output in the compute
dtype, the bias, the fp32 filters.
"""

from __future__ import annotations

import copy

from . import flops
from .k1 import DTYPE_BYTES
from ..reference import generator as ref
from ..reference import sg3


def specs(config: dict) -> list:
    return sg3.layer_specs(ref.Arch(config["generator"]), filters=False)


def _shared(config: dict) -> int:
    """generator_frame with no superres octave (an output size below the
    render size): the vb stack, the decoder and the raw head."""
    cut = copy.deepcopy(config)
    cut["generator"]["img_resolution"] = cut["generator"]["render_size"] // 2
    return flops.generator_frame(cut)


def stack_flops(config: dict) -> int:
    w = config["generator"]["w_dim"]
    n = 0
    for s in specs(config):
        cin, cout, k = s["cin"], s["cout"], s["k"]
        n += 2 * w * cin + 2 * cin * cout * k * k * (s["in_size"] + k - 1) ** 2
        if not s["torgb"]:
            n += 2 * cin * cout  # demodulation coefficients
    return n


def frame_flops(config: dict) -> int:
    return _shared(config) + stack_flops(config)


def launch_bytes(config: dict, B: int) -> list:
    """Bytes of each of the stack's filtered_lrelu calls at batch B, in order."""
    vb = DTYPE_BYTES[config["generator"]["dtype"]]
    out = []
    for s in specs(config):
        n, o = s["in_size"] + s["k"] - 1, s["out_size"]  # the conv output's side, the output's
        c = s["cout"]
        filters = 4 * ((s["up_taps"] if s["up_taps"] > 1 else 0) + (s["down_taps"] if s["down_taps"] > 1 else 0))
        out.append(B * c * (n * n + o * o) * vb + c * vb + filters)
    return out

