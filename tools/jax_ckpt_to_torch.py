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
kept. A training snapshot (one that holds `opt_g`) is read through a JAX
`init_gan_state` template, as the JAX CLI's `--resume` reads it, and also
carries the discriminator (the CLI's `Discriminator(img_resolution,
img_channels=25)`), both optimizers and pl_mean, so that
`python -m ide3d_tpu_torch.apps.train_gan --resume <dest>` continues the run:
each optax Adam state becomes a torch `Adam` state dict in the order of the
module's `parameters()` (`step` = count, `exp_avg` = mu, `exp_avg_sq` = nu,
each through its parameter's layout conversion; lr from the CLI's defaults,
betas (0, 0.99), eps 1e-8). The moments of leaves that are buffers in the
port (w_avg, the const noise) are dropped: the port's Adam does not hold
them, and the JAX step gives them no gradient. Every option of the JAX
GeneratorConfig and RenderParams converts (the hybrid feature volume, the SG3
superres stack, the built-in encoder and its camera head, fine_steps); a
configuration field the port lacks is refused by name, and so is a tree
whose leaves do not map onto the port's modules.

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


def _jax_train_template(jcfg):
    """The JAX CLI's training state for `jcfg` (its structure, with numpy
    zeros of each leaf's shape: nothing is initialised), to restore into."""
    import functools

    import jax

    from ide3d_tpu.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu.models.generator import Ide3dGenerator
    from ide3d_tpu.train.gan import GanTrainConfig, d_input_channels, init_gan_state

    tcfg = GanTrainConfig()
    D = Discriminator(DiscriminatorConfig(img_resolution=jcfg.img_resolution,
                                          img_channels=d_input_channels(tcfg, jcfg)))
    shapes = jax.eval_shape(functools.partial(init_gan_state, G=Ide3dGenerator(jcfg), D=D,
                                              tcfg=tcfg), jax.random.PRNGKey(0))
    tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return {"G": tmpl.params_g, "D": tmpl.params_d, "G_ema": tmpl.params_g_ema,
            "opt_g": tmpl.opt_g, "opt_d": tmpl.opt_d, "pl_mean": tmpl.pl_mean}


def _adam_state_dict(opt, make_module, jax_opt_state) -> dict:
    """The optax Adam state (count, mu, nu) as `opt`'s state dict, in the
    order of make_module().parameters(), mu and nu in the port's layouts."""
    import jax
    import torch

    from ide3d_tpu_torch.io.from_jax import load_jax_params

    (adam,) = [s for s in jax_opt_state if hasattr(s, "mu")]
    moments = [list(load_jax_params(make_module(), jax.tree_util.tree_map(np.asarray, tree))
                    .parameters()) for tree in (adam.mu, adam.nu)]
    sd = opt.state_dict()
    step = torch.tensor(float(np.asarray(adam.count)))
    sd["state"] = {i: {"step": step.clone(), "exp_avg": m.detach().clone(),
                       "exp_avg_sq": v.detach().clone()}
                   for i, (m, v) in enumerate(zip(*moments))}
    opt.load_state_dict(sd)  # refuses a count of tensors that is not the module's
    return opt.state_dict()


def _train_state(params: dict, cfg) -> dict:
    """D, opt_g, opt_d and pl_mean of a JAX training snapshot, in the port's
    checkpoint layout."""
    import jax
    import torch

    from ide3d_tpu_torch.io.from_jax import load_jax_params
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.train.gan import GanTrainConfig, d_input_channels, init_gan_state

    tcfg = GanTrainConfig()
    dcfg = DiscriminatorConfig(img_resolution=cfg.img_resolution,
                               img_channels=d_input_channels(tcfg, cfg))
    D = load_jax_params(Discriminator(dcfg), jax.tree_util.tree_map(np.asarray, params["D"]))
    st = init_gan_state(Ide3dGenerator(cfg), D, tcfg)
    return {"D": D.state_dict(),
            "opt_g": _adam_state_dict(st.opt_g, lambda: Ide3dGenerator(cfg), params["opt_g"]),
            "opt_d": _adam_state_dict(st.opt_d, lambda: Discriminator(dcfg), params["opt_d"]),
            "pl_mean": torch.tensor(float(np.asarray(params["pl_mean"])))}


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

    if "opt_g" in params:
        params = load_checkpoint(src, template=_jax_train_template(jcfg))[0]
    trees = {k: params[k] for k in ("G", "G_ema") if k in params} or {"G_ema": params}
    state = {}
    for key, tree in trees.items():
        G = load_jax_params(Ide3dGenerator(cfg), jax.tree_util.tree_map(np.asarray, tree))
        state[key] = G.state_dict()
    if "opt_g" in params:
        state.update(_train_state(params, cfg))
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
