"""Bytes K1 (the depth sort and composite, `csrc/ray_march.cu`) must move,
from the shapes alone: each input read once and each output written once.

Forward: the two halves' depths (fp32) and values (the compute dtype), the
rays' norms (fp32) in; the composited features, depth and weight sum (fp32)
out. Backward: the forward's inputs and the three cotangents (fp32) in, the
values' gradients (the compute dtype) out.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def shapes(config: dict) -> dict:
    """K1's sizes of a configuration: rays R, coarse S and fine F samples a ray,
    values C+1 a sample (features, semantics, density) and their bytes."""
    g = config["generator"]
    rp = g["render"]
    return {"R": rp["img_size"] ** 2, "S": rp["num_steps"],
            "F": rp["fine_steps"] or rp["num_steps"],
            "C1": g["feature_channels"] + g["seg_channels"] + 1,
            "vb": DTYPE_BYTES[g["dtype"]]}


def forward_bytes(config: dict, B: int) -> int:
    k = shapes(config)
    R, S, F, C1, vb = k["R"], k["S"], k["F"], k["C1"], k["vb"]
    inputs = B * R * ((S + F) * 4 + (S + F) * C1 * vb + 4)
    return inputs + B * R * (C1 + 1) * 4


def backward_bytes(config: dict, B: int) -> int:
    k = shapes(config)
    R, S, F, C1, vb = k["R"], k["S"], k["F"], k["C1"], k["vb"]
    inputs = B * R * ((S + F) * 4 + (S + F) * C1 * vb + 4)
    cotangents = B * R * (C1 + 1) * 4
    grads = B * R * (S + F) * C1 * vb
    return inputs + cotangents + grads
