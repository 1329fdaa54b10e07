"""Torch-native checkpoints: a directory with the state dicts and a JSON meta.

Counterpart of ide3d_tpu/io/checkpoint.py (config + weights, never pickled
source code): `path/state.pt` holds a dict of state dicts and tensors (the
train state: G, D, G_ema, opt_g, opt_d, pl_mean), written by `torch.save`
and read back with `weights_only=True`; `path/meta.json` holds the step, any
extra scalars (e.g. ada_p) and the config as JSON, dataclasses tagged with
their class name as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch


def _config_to_jsonable(cfg: Any):
    if dataclasses.is_dataclass(cfg):
        return {"__dataclass__": type(cfg).__name__,
                **{f.name: _config_to_jsonable(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}}
    if isinstance(cfg, (list, tuple)):
        return [_config_to_jsonable(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: _config_to_jsonable(v) for k, v in cfg.items()}
    return cfg


def config_from_jsonable(obj: Any, registry: Optional[dict] = None):
    """Inverse of the config serialization: '__dataclass__'-tagged dicts are
    rebuilt through `registry` (by default the port's config types)."""
    if registry is None:
        from ..models.discriminator import DiscriminatorConfig
        from ..models.generator import GeneratorConfig
        from ..render.renderer import RenderParams

        registry = {"GeneratorConfig": GeneratorConfig, "DiscriminatorConfig": DiscriminatorConfig,
                    "RenderParams": RenderParams}
    if isinstance(obj, dict) and "__dataclass__" in obj:
        cls = registry.get(obj["__dataclass__"])
        fields = {k: config_from_jsonable(v, registry) for k, v in obj.items() if k != "__dataclass__"}
        if cls is None:
            return fields
        valid = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in fields.items() if k in valid})
    if isinstance(obj, dict):
        return {k: config_from_jsonable(v, registry) for k, v in obj.items()}
    if isinstance(obj, list):
        return [config_from_jsonable(v, registry) for v in obj]
    return obj


def save_checkpoint(path: str, state: dict, config: Any = None, step: Optional[int] = None,
                    **extra_meta) -> None:
    """Write `state` (state dicts, tensors) and the meta under the directory `path`."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, "state.pt.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    meta = {"step": step, **extra_meta}
    if config is not None:
        meta["config"] = _config_to_jsonable(config)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, map_location="cpu"):
    """Returns (state, meta)."""
    state = torch.load(os.path.join(path, "state.pt"), map_location=map_location, weights_only=True)
    meta = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta
