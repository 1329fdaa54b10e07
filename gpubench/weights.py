"""Seeded weights for a module, drawn on its device in one call.

A configuration file lists `init` rules, [regex, "normal", scale] or [regex,
"const", value], tried in order on each state-dict name: the first that matches
gives the entry's distribution (the program's own init: unit normals, scaled by
1 / lr for the mapping, constant biases). One torch.Generator on the device,
seeded with the run's seed, draws every normal in one `randn` call, in
state-dict order, so the same seed gives the same weights on the same device.
"""

from __future__ import annotations

import re

import torch

SEED_MOD = 2**63


def draw_state(shapes: dict, rules: list, seed: int, device) -> dict:
    """{name: shape} -> {name: float32 tensor on `device`} by the `init` rules."""
    compiled = [(re.compile(p), kind, float(v)) for p, kind, v in rules]
    plan, total = [], 0
    for name, shape in shapes.items():
        rule = next(((kind, v) for p, kind, v in compiled if p.search(name)), None)
        if rule is None:
            raise ValueError(f"no init rule matches {name!r}")
        n = 1
        for s in shape:
            n *= int(s)
        plan.append((name, tuple(shape), rule, total, n))
        if rule[0] == "normal":
            total += n
    gen = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    flat = torch.randn(total, generator=gen, device=device)
    out = {}
    for name, shape, (kind, v), off, n in plan:
        if kind == "normal":
            out[name] = flat[off:off + n].view(shape) * v if v != 1.0 else flat[off:off + n].view(shape)
        elif kind == "const":
            out[name] = torch.full(shape, v, device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r}")
    return out


def load_seeded(module: torch.nn.Module, rules: list, seed: int) -> None:
    """Draw the module's state on its device and load it."""
    dev = next(module.parameters()).device
    shapes = {k: v.shape for k, v in module.state_dict().items()}
    module.load_state_dict(draw_state(shapes, rules, seed, dev))
