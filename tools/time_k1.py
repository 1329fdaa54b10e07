"""Times K1 (`sort_integrate`), its backward or its double backward, of one
checkout of the port.

    python3 tools/time_k1.py [--tree DIR] [--backward | --double-backward]

Imports `ide3d_tpu_torch` from DIR (default: the checkout this script is in),
so that two commits' kernels are timed on the same card, one process each:
unpack the other commit with `git archive <commit> | tar -x -C DIR`.
The kernel is built from DIR's own source, and only entry points that every
version of the port since its backward has are called.

Forward (default): `sort_integrate(z_a, vals_a, z_b, vals_b, ray_norm)` at
bf16 values, R=4096, S=96+96, C+1=52, for B=1 and B=3, with halves sorted (as
the deterministic frame has them) and unsorted (a render with a generator),
held against the plain version (max abs err <= 1e-3).

--backward: `sort_integrate_backward(z_a, vals_a, z_b, vals_b, ray_norm,
g_feat, g_depth, g_wsum)` at the training render's layout (bf16, B=4,
R=4096, S=96+96, C+1=52, coarse half sorted, fine half unsorted), held
against autograd through the plain version (max abs err <= 1e-2 x max|grad|),
then the forward and the pair forward + backward at the same inputs.

--double-backward: `sort_integrate_double_backward(..., gg_a, gg_b)` at the
same layout, held against autograd (create_graph) through the plain version
(max abs err <= 1e-2 x max|grad|, value and cotangent gradients each against
their own max), beside its byte bound and the plain version's event time;
where the checkout has `double_backward_plan`, also the same inputs with
gg_a misaligned (its streamed plan) and each timing's plan. It first prints
the build line of chip_smoke.py (each kernel's registers and spills from
`nvcc -Xptxas -v`; "(cached)" when the checkout's library was already
built). For an A/B, run it for this tree and another in turns, one process
each, in one GPU-tool call (other, this, this, other).

Each case prints, with chip_smoke.py's timers:
  graph_ms  device time per call, from a CUDA graph of 20 calls over two input sets
  eager_ms  time between CUDA events around one eager call (host + kernel)
  host_ms   host time of one eager call until it returns
one line per case, then one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _smoke_helpers():
    """chip_smoke.py of this checkout (DIR may hold a chip_smoke.py of its own)."""
    spec = importlib.util.spec_from_file_location("k1_timing_helpers", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _timed(smoke, calls, nbytes: int) -> dict:
    graph = smoke.graph_ms(calls, 20)
    eager, host = smoke.eager_ms(calls[0])
    bound = nbytes / smoke.HBM_BYTES_PER_MS
    return {"graph_ms": graph, "eager_ms": eager, "host_ms": host, "bytes": nbytes,
            "bound_ms": bound}


def _line(name: str, tree: Path, shape: str, smi: str, r: dict) -> None:
    share = 100 * r["bound_ms"] / r["graph_ms"]
    print(f"{name} {tree} {shape} ({smi}): graph {r['graph_ms']:.4f} ms "
          f"({share:.1f}% of the {r['bound_ms'] * 1e3:.2f} us bound), "
          f"eager {r['eager_ms']:.4f} ms, host {r['host_ms']:.4f} ms"
          + (f"; max abs err {r['max_abs_err']:.3g}" if "max_abs_err" in r else ""), flush=True)


def time_forward(smoke, tree: Path, smi: str) -> dict:
    from ide3d_tpu_torch.ops.ray_march import sort_integrate, sort_integrate_plain

    gen = torch.Generator().manual_seed(1)
    result = {}
    for B in (1, 3):
        for halves in ("sorted", "unsorted"):
            sets = [smoke.k1_inputs(gen, torch.bfloat16, B=B, sorted_halves=halves == "sorted")
                    for _ in range(2)]
            err = smoke.max_err(sort_integrate(*sets[0]), sort_integrate_plain(*sets[0]))
            if err > 1e-3:
                raise RuntimeError(f"B={B} {halves}: max abs err vs plain {err} > 1e-3")
            r = _timed(smoke, [lambda a=a: sort_integrate(*a) for a in sets],
                       smoke.k1_bytes(sets[0]))
            r["max_abs_err"] = err
            result[f"B{B}_{halves}"] = r
            _line("K1", tree, f"B={B} {halves} halves, bf16 R=4096 S=96+96 C=51", smi, r)
            del sets
    return result


def time_backward(smoke, tree: Path, smi: str) -> dict:
    from ide3d_tpu_torch.ops.ray_march import (sort_integrate, sort_integrate_backward,
                                               sort_integrate_backward_plain)

    gen = torch.Generator().manual_seed(7)
    sets = smoke.training_k1_sets(gen)
    got = sort_integrate_backward(*sets[0][0], *sets[0][1])
    err = smoke.rel_err(got, sort_integrate_backward_plain(*sets[0][0], *sets[0][1]))
    if err > 1e-2:
        raise RuntimeError(f"backward: max abs err / max|grad| vs plain {err} > 1e-2")
    shape = "B=4 bf16 R=4096 S=96+96 C=51, coarse sorted, fine unsorted"
    bwd_bytes = smoke.k1_backward_bytes(*sets[0])
    fwd_bytes = smoke.k1_bytes(sets[0][0])
    result = {"backward": _timed(smoke, [lambda s=s: sort_integrate_backward(*s[0], *s[1])
                                         for s in sets], bwd_bytes)}
    result["backward"]["max_abs_err"] = err
    _line("K1 backward", tree, shape, smi, result["backward"])
    result["forward"] = _timed(smoke, [lambda s=s: sort_integrate(*s[0]) for s in sets], fwd_bytes)
    _line("K1 forward", tree, shape, smi, result["forward"])
    result["forward_backward"] = _timed(
        smoke, [lambda s=s: (sort_integrate(*s[0]), sort_integrate_backward(*s[0], *s[1]))
                for s in sets], fwd_bytes + bwd_bytes)
    _line("K1 forward + backward", tree, shape, smi, result["forward_backward"])
    return result


def time_double_backward(smoke, tree: Path, smi: str) -> dict:
    from ide3d_tpu_torch.ops import ray_march

    gen = torch.Generator().manual_seed(13)
    sets = [(a, c, [torch.randn(v.shape, generator=gen).to("cuda", v.dtype) for v in (a[1], a[3])])
            for a, c in smoke.training_k1_sets(gen)]
    variants = {"": sets}
    if hasattr(ray_march, "double_backward_plan"):  # the first design has one plan
        variants["misaligned gg_a "] = [(a, c, [smoke.misaligned_copy(g[0]), g[1]])
                                        for a, c, g in sets]
    shape = "B=4 bf16 R=4096 S=96+96 C=51, coarse sorted, fine unsorted"
    nbytes = smoke.k1_double_backward_bytes(*sets[0])
    result = {}
    for label, vs in variants.items():
        args = (*vs[0][0], *vs[0][1], *vs[0][2])
        ref = ray_march.sort_integrate_double_backward_plain(*args)
        err = smoke.group_err(ray_march.sort_integrate_double_backward(*args), ref)
        del ref
        if err > 1e-2:
            raise RuntimeError(f"double backward {label}: max abs err / max|grad| vs plain {err} "
                               f"> 1e-2")
        plan = (ray_march.double_backward_plan(*args) if hasattr(ray_march, "double_backward_plan")
                else "the only")
        r = _timed(smoke, [lambda s=s: ray_march.sort_integrate_double_backward(*s[0], *s[1], *s[2])
                           for s in vs], nbytes)
        r.update(max_abs_err=err, plan=plan)
        if not label:
            r["plain_ms"] = smoke.event_median_ms(
                lambda: ray_march.sort_integrate_double_backward_plain(*args), runs=5)
        result[f"double_backward{'_' + label.split()[0] if label else ''}"] = r
        _line(f"K1 double backward, {label}{plan} plan", tree, shape, smi, r)
    print(f"K1 double backward plain (autograd with create_graph, event ms) "
          f"{result['double_backward']['plain_ms']:.4f}", flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="root of the checkout to time")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--backward", action="store_true",
                       help="time the backward at the training layout (B=4)")
    which.add_argument("--double-backward", action="store_true",
                       help="time the double backward at the training layout (B=4)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    smoke = _smoke_helpers()
    smi = smoke.phase_device().splitlines()[0]
    result = {"tree": str(args.tree), "device": smi}
    if args.double_backward:
        smoke.phase_build()
    timer = (time_double_backward if args.double_backward else
             time_backward if args.backward else time_forward)
    result.update(timer(smoke, args.tree, smi))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
