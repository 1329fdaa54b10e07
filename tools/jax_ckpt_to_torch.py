"""Convert a JAX-package snapshot into a snapshot of the PyTorch port.

    python3 tools/jax_ckpt_to_torch.py --src runs/tpu/snapshot-final --dest runs/card/snapshot-final

`--src` is a directory written by `ide3d_tpu.io.checkpoint.save_checkpoint`
(an orbax `params` tree and `meta.json`), as `ide3d_tpu.apps.train_gan`
writes its snapshots. Its generator trees (`G` and `G_ema`; a tree without
them is taken as one generator's parameters) go through
`ide3d_tpu_torch.io.from_jax.load_jax_params` into `Ide3dGenerator`s of the
same configuration, and `--dest` gets them as `state.pt` + `meta.json`
(`ide3d_tpu_torch.io.checkpoint`), which `ide3d_tpu_torch.apps.common.
load_generator` reads. The step and the scalar metadata (e.g. ada_p) are
kept. The discriminator and the optimizer states are not carried over. Every
option of the JAX GeneratorConfig and RenderParams converts (the hybrid
feature volume, the SG3 superres stack, the built-in encoder and its camera
head, fine_steps); a configuration field the port lacks is refused by name.

Imports both packages; it runs on the host (numpy and the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _unported(jax_cfg, port_cls, where: str) -> list:
    """Fields of the JAX dataclass `jax_cfg` that the port's `port_cls` lacks
    and that differ from the JAX default."""
    own = {f.name for f in dataclasses.fields(port_cls)}
    return [f"{where}{f.name}={getattr(jax_cfg, f.name)!r}" for f in dataclasses.fields(jax_cfg)
            if f.name not in own and getattr(jax_cfg, f.name) != f.default]


def convert(src: str, dest: str) -> None:
    """Write the port snapshot of the JAX snapshot `src` to `dest`."""
    import jax

    from ide3d_tpu.io.checkpoint import config_from_jsonable as jax_config
    from ide3d_tpu.io.checkpoint import load_checkpoint
    from ide3d_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
    from ide3d_tpu_torch.io import checkpoint
    from ide3d_tpu_torch.io.from_jax import load_jax_params
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.render.renderer import RenderParams

    params, meta = load_checkpoint(src)
    cfg_json = meta.get("config") or {}
    jcfg = jax_config(cfg_json) if cfg_json else JaxGeneratorConfig()
    if not isinstance(jcfg, JaxGeneratorConfig):
        raise ValueError(f"{src}: meta.json holds no GeneratorConfig")
    bad = _unported(jcfg, GeneratorConfig, "") + _unported(jcfg.render, RenderParams, "render.")
    if bad:
        raise ValueError(f"{src}: options the port does not have: {', '.join(bad)}")
    cfg = checkpoint.config_from_jsonable(cfg_json) if cfg_json else GeneratorConfig()

    trees = {k: params[k] for k in ("G", "G_ema") if k in params} or {"G_ema": params}
    state = {}
    for key, tree in trees.items():
        G = load_jax_params(Ide3dGenerator(cfg), jax.tree_util.tree_map(np.asarray, tree))
        state[key] = G.state_dict()
    extra = {k: v for k, v in meta.items() if k not in ("config", "step")}
    checkpoint.save_checkpoint(dest, state, config=cfg, step=meta.get("step"), **extra)
    print(f"wrote {dest}: {', '.join(state)} at step {meta.get('step')}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="JAX snapshot directory (orbax params + meta.json)")
    ap.add_argument("--dest", required=True, help="port snapshot directory to write")
    args = ap.parse_args(argv)
    convert(args.src, args.dest)


if __name__ == "__main__":
    main()
