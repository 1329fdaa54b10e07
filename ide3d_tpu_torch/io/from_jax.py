"""Load the JAX package's parameter tree into this package's modules.

The JAX tree is nested dicts of arrays; hand it over as numpy
(`jax.tree_util.tree_map(np.asarray, params)`). Module and parameter names
match the tree's keys, so each entry of the module's state_dict is looked up
by its dotted path and converted:

  * 4-D conv weights      HWIO [kh, kw, I, O] -> OIHW [O, I, kh, kw]
  * FC `weight`           [in, out]           -> [out, in]
  * block `const`         [H, W, C]           -> [C, H, W]
  * everything else (biases, noise, w_avg, renderer decoder) as it is.

Every tensor of the module must be found with the expected shape, and every
leaf of the tree must be used; anything else raises. Imports numpy and torch only.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_leaves(v, name + "."))
        else:
            out[name] = v
    return out


def _convert(name: str, a: np.ndarray) -> np.ndarray:
    leaf = name.rsplit(".", 1)[-1]
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if leaf == "weight" and a.ndim == 2:
        return a.T
    if leaf == "const" and a.ndim == 3:
        return a.transpose(2, 0, 1)
    return a


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy `tree` (nested dicts of numpy arrays) into `module` in place; returns it."""
    leaves = _leaves(tree)
    state = module.state_dict()
    missing = sorted(set(state) - set(leaves))
    unused = sorted(set(leaves) - set(state))
    if missing or unused:
        raise KeyError(f"JAX tree does not match the module: missing {missing}, unused {unused}")
    with torch.no_grad():
        for name, dst in state.items():
            src = torch.from_numpy(np.array(_convert(name, np.asarray(leaves[name])), order="C"))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: JAX shape {tuple(src.shape)} after conversion, "
                                 f"module shape {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return module
