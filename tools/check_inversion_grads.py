"""Where the card's fp32 inversion gradients part from the CPU's, on one CUDA
card.

    python3 tools/check_inversion_grads.py [--out out]

The flagship GeneratorConfig() from init(seed=0) and a target as chip_smoke.py
phase 10 makes them. First phase 10's gradient check
(chip_smoke.inversion_card_vs_cpu: fp32 copies, card with cuDNN and with
PyTorch's own convolutions against the CPU in fp32 and in float64) at noise
strengths 0.1, as phase 10 runs it, and 0, where the noise buffers do not
enter. Then an fp32 copy with noise strengths 0.1 runs one projector step and
one PTI step on the card (chip_smoke.inversion_grads, the CPU's importance
depths replayed, TF32 off), and every convolution of that run
(`ops.conv2d_gradfix`: the forward, and in the backward the input gradient
and the weight gradient) is recomputed on the CPU from the card's own inputs,
and again on the card with cuDNN off. For each it records max |card - CPU| /
max |CPU|, with cuDNN and with PyTorch's own CUDA convolutions, and prints
the largest; the whole list goes to <out>/inversion_convs.json. A
convolution that computed a different function would stand far above fp32
rounding (~1e-6). Needs CUDA; fails without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((got.double().cpu() - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="out")
    args = ap.parse_args()
    smi = cs.phase_device()
    cs.phase_build()

    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.apps.infer_hybrid_encoder import load_image
    from ide3d_tpu_torch.models.generator import GeneratorConfig
    from ide3d_tpu_torch.ops import conv2d_gradfix as cg
    from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25

    rows = []
    real_f, real_b = cg._Conv2d.forward, cg._Conv2d.backward
    native = lambda: torch.backends.cudnn.flags(enabled=False)  # noqa: E731

    def fwd(ctx, x, w, stride, padding, groups):
        y = real_f(ctx, x, w, stride, padding, groups)
        if x.is_cuda:
            ref = F.conv2d(x.cpu(), w.cpu(), None, stride, padding, 1, groups)
            with native():
                nat = F.conv2d(x, w, None, stride, padding, 1, groups)
            rows.append({"op": "forward", "x": list(x.shape), "w": list(w.shape),
                         "groups": groups, "cudnn": rel(y, ref), "native": rel(nat, ref)})
        return y

    def bwd(ctx, g):
        out = real_b(ctx, g)
        x, w = ctx.saved_tensors
        if g.is_cuda:
            stride, padding, groups = ctx.conf
            out_pad = [x.shape[i + 2] - ((g.shape[i + 2] - 1) * stride[i] - 2 * padding[i]
                                         + w.shape[i + 2]) for i in range(2)]

            def dgrad(g, w):
                return F.conv_transpose2d(g, w, None, stride, padding, out_pad, groups)

            def wgrad(g, x, w):
                return torch.ops.aten.convolution_backward(
                    g, x, w, None, stride, padding, (1, 1), False, (0, 0), groups,
                    (False, True, False))[1]

            pairs = [("input_grad", out[0], dgrad, (g, w))]
            if out[1] is not None:
                pairs.append(("weight_grad", out[1], wgrad, (g, x, w)))
            for name, got, fn, inputs in pairs:
                ref = fn(*(t.cpu() for t in inputs))
                with native():
                    nat = fn(*inputs)
                rows.append({"op": name, "x": list(x.shape), "w": list(w.shape),
                             "groups": groups, "cudnn": rel(got, ref), "native": rel(nat, ref)})
        return out

    with tempfile.TemporaryDirectory() as root:
        snap = os.path.join(root, "flagship")
        cs.write_snapshot(snap, GeneratorConfig(), seed=0)
        G = common.load_generator(snap, "cuda")
        imgs, _ = cs.write_targets(G, root, 1)
        target = torch.as_tensor(load_image(os.path.join(imgs, "t0.png"), cs.INV_RES))[None]
        c = torch.as_tensor(CANONICAL_POSE_25)[None]
        for strength in (0.1, 0.0):
            gaps = cs.inversion_card_vs_cpu(G, target, c, strength)
            print(f"inversion gradients, noise strengths {strength} "
                  f"({smi.splitlines()[0]}), max abs err / max|grad|: " + "; ".join(
                      f"{pair}: w+ {e['w']:.3g} (rows 0-4 {e['w_rows'][:5]}), noise "
                      f"{e['noise']:.3g}, PTI {e['pti']:.3g}" for pair, e in gaps.items()),
                  flush=True)
        cg._Conv2d.forward, cg._Conv2d.backward = staticmethod(fwd), staticmethod(bwd)
        try:
            fp32 = contextlib.nullcontext
            cs.inversion_grads(G, target, c, [("cpu32", "cpu", torch.float32, fp32),
                                              ("card32", "cuda", torch.float32, fp32)])
        finally:
            cg._Conv2d.forward, cg._Conv2d.backward = real_f, real_b
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "inversion_convs.json"), "w") as f:
        json.dump(rows, f, indent=0)
    worst = {k: max(rows, key=lambda r: r[k]) for k in ("cudnn", "native")}
    print(f"inversion convolutions, card vs the same convolution on the CPU from the card's "
          f"inputs, fp32, TF32 off ({smi.splitlines()[0]}): {len(rows)} convolutions; max abs "
          f"err / max|CPU| with cuDNN {worst['cudnn']['cudnn']:.3g} ({worst['cudnn']['op']} "
          f"x {worst['cudnn']['x']} w {worst['cudnn']['w']}), with PyTorch's own "
          f"{worst['native']['native']:.3g} ({worst['native']['op']} x {worst['native']['x']} "
          f"w {worst['native']['w']}); median with cuDNN "
          f"{sorted(r['cudnn'] for r in rows)[len(rows) // 2]:.3g}, with PyTorch's own "
          f"{sorted(r['native'] for r in rows)[len(rows) // 2]:.3g}", flush=True)


if __name__ == "__main__":
    main()
