"""Load the JAX package's parameter tree into this package's modules.

The JAX tree is nested dicts of arrays; hand it over as numpy
(`jax.tree_util.tree_map(np.asarray, params)`). Module and parameter names
match the tree's keys, so each entry of the module's state_dict is looked up
by its dotted path and converted:

  * 4-D conv weights      HWIO [kh, kw, I, O] -> OIHW [O, I, kh, kw]
  * 5-D conv weights      DHWIO [kd, kh, kw, I, O] -> OIDHW (the feature volume)
  * FC `weight`           [in, out]           -> [out, in]
  * block `const`         [H, W, C]           -> [C, H, W]
  * volume `const`        [1, D, H, W, C]     -> [1, C, D, H, W]
  * everything else (biases, noise, w_avg, magnitude_ema, renderer decoder)
    as it is.

Every tensor of the module must be found with the expected shape, and every
leaf of the tree must be used; anything else raises. The same holds for the
LevelsMapper and MultiViewHybridEncoder trees. CLIP's tree (`load_jax_clip`)
keeps the OpenAI names with two leaves laid out otherwise: `attn.in_proj_weight`
arrives [D, 3D] and is transposed back, `token_embedding.weight` is a
[vocab, D] lookup table and stays as it is. Imports numpy and torch only.
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
    if a.ndim == 5:
        return a.transpose(0, 4, 1, 2, 3) if leaf == "const" else a.transpose(4, 3, 0, 1, 2)
    if leaf == "weight" and a.ndim == 2:
        return a.T
    if leaf == "const" and a.ndim == 3:
        return a.transpose(2, 0, 1)
    return a


def _convert_clip(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith("attn.in_proj_weight"):
        return a.T
    if name == "token_embedding.weight":
        return a
    return _convert(name, a)


def load_jax_params(module: nn.Module, tree: Mapping, convert=_convert) -> nn.Module:
    """Copy `tree` (nested dicts of numpy arrays) into `module` in place,
    each leaf through `convert(name, array)`; returns the module."""
    leaves = _leaves(tree)
    state = module.state_dict()
    missing = sorted(set(state) - set(leaves))
    unused = sorted(set(leaves) - set(state))
    if missing or unused:
        raise KeyError(f"JAX tree does not match the module: missing {missing}, unused {unused}")
    with torch.no_grad():
        for name, dst in state.items():
            src = torch.from_numpy(np.array(convert(name, np.asarray(leaves[name])), order="C"))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: JAX shape {tuple(src.shape)} after conversion, "
                                 f"module shape {tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))
    return module


def load_jax_clip(module: nn.Module, tree: Mapping) -> nn.Module:
    """The JAX package's CLIP params (ide3d_tpu.models.clip) into models/clip.CLIP."""
    return load_jax_params(module, tree, _convert_clip)
