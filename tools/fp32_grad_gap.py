"""How far fp32 gradients lie from float64 ones, in the JAX package and in the
port, at the inputs of two CPU parity tests: the projector step of
tests/test_torch_inversion.py (w+ and noise gradients, the tiny G at layer-noise
strength 0.3) and the StyleCLIP mapper step of tests/test_torch_editing.py (the
mapper's gradients through the tiny G, the tiny CLIP and ArcFace at half the
JAX init's conv std).

    python3 tools/fp32_grad_gap.py [--case projector|mapper|both]

Both packages start from the JAX package's fp32 initialisations (the port's
copies bridged through io/from_jax). Four gradients per case:
  jax32  the JAX package in fp32 (jax.grad, jitted);
  jax64  the JAX package in float64: a subprocess with jax_enable_x64, the same
         fp32 parameters and inputs cast to float64, the configs' compute dtype
         "float64" and jnp.float32 read as float64, so that the package's own
         casts to float32 keep float64;
  port32 the port in fp32 (autograd);
  port64 the port in float64 (chip_smoke.float64_render: the "float32" compute
         dtype and the port's .float() casts keep float64).
One JSON line per case gives max |a - b| / max |b| for each gradient group
and pair. Run it from the repo root; it imports both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8)
CLIP_CFG = dict(embed_dim=16, image_resolution=32, vision_layers=1, vision_width=32,
                vision_patch_size=8, context_length=12, vocab_size=520, transformer_width=32,
                transformer_layers=1, head_dim=16)
MERGES = [("l", "o"), ("lo", "w</w>")]


def gap(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| for each group of gradients."""
    return {k: float(max(np.abs(g - r).max() for g, r in zip(got[k], ref[k]))
                     / max(np.abs(r).max() for r in ref[k])) for k in ref}


# ------------------------------------------------------------------- JAX side


def _jax_models(dtype: str):
    import jax

    from ide3d_tpu.models import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu.models import clip as jclip
    from ide3d_tpu.models.arcface import ArcFaceIRSE50
    from ide3d_tpu.render.renderer import RenderParams
    from ide3d_tpu.editing import latent_editor as jle

    jG = Ide3dGenerator(GeneratorConfig(**TINY, dtype=dtype,
                                        render=RenderParams(img_size=8, num_steps=4)))
    return jax, jG, jclip, ArcFaceIRSE50, jle


def jax_grads(case: str, data: dict, x64: bool) -> dict:
    """The case's gradients by the JAX package, on `data`'s fp32 trees cast to
    float64 when x64."""
    jax, jG, jclip, JArcFace, jle = _jax_models("float64" if x64 else "float32")
    import jax.numpy as jnp

    from ide3d_tpu import render as jrender
    from ide3d_tpu.train import pti as jpti

    ft = jnp.float64 if x64 else jnp.float32

    def cast(tree):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, ft) if np.asarray(x).dtype.kind == "f" else jnp.asarray(x), tree)

    gp = cast(data["g_params"])
    if case == "projector":
        c, target = cast(data["c"]), cast(data["target"])
        cfg = jpti.ProjectorConfig()
        t_feats = [jax.lax.stop_gradient(f) for f in jpti.default_pyramid_feats(target)]

        def loss(varz):
            sp = jpti.merge_noise(gp["synthesis"], varz["noise"])
            img = jG.synthesis(sp, varz["w"], c, noise_mode="const")
            dist = sum(jnp.mean(jnp.square(a - b))
                       for a, b in zip(jpti.default_pyramid_feats(img), t_feats))
            return dist + cfg.noise_reg_weight * jpti.noise_regularization(varz["noise"])

        g = jax.jit(jax.grad(loss))({"w": cast(data["w"]), "noise": cast(data["noise"])})
        return {"w": [np.asarray(g["w"], np.float64)],
                "noise": [np.asarray(g["noise"][k], np.float64) for k in sorted(data["noise"])]}
    jm = jclip.CLIP(cfg=jclip.ClipConfig(**CLIP_CFG))
    cp, arc_tree = cast(data["clip"]), cast(data["arcface"])
    jarc = JArcFace()
    jmapper = jle.LevelsMapper(w_dim=512, num_ws=jG.num_ws)
    tokens = jnp.asarray(data["tokens"])
    c = jnp.asarray(np.broadcast_to(jrender.CANONICAL_POSE_25, (2, 25)), ft)

    def loss(mp, w):
        w_hat = w + 0.1 * jmapper(mp, w)
        x_hat = jG.synthesis(gp["synthesis"], w_hat, c)
        l_clip = jnp.mean(jclip.clip_similarity_loss(jm, cp, x_hat, tokens))
        x = jax.lax.stop_gradient(jG.synthesis(gp["synthesis"], w, c))
        e_hat, e = jarc.embed_faces(arc_tree, x_hat), jax.lax.stop_gradient(
            jarc.embed_faces(arc_tree, x))
        e_hat = e_hat / jnp.linalg.norm(e_hat, axis=-1, keepdims=True)
        e = e / jnp.linalg.norm(e, axis=-1, keepdims=True)
        l_id = jnp.mean(1.0 - jnp.sum(e_hat * e, axis=-1))
        return l_clip + 0.1 * l_id + 0.8 * jnp.mean((w_hat - w) ** 2)

    g = jax.jit(jax.grad(loss))(cast(data["mapper"]), cast(data["w"]))
    leaves = jax.tree_util.tree_flatten_with_path(g)[0]
    return {"mapper": [np.asarray(v, np.float64).T if v.ndim == 2 else np.asarray(v, np.float64)
                       for _, v in sorted(leaves, key=lambda kv: jax.tree_util.keystr(kv[0]))]}


def jax_x64_worker(case: str, path: str) -> None:
    """In this process only: float64 on, jnp.float32 read as float64."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    jnp.float32 = jnp.float64
    with open(path, "rb") as f:
        data = pickle.load(f)
    with open(path + ".out", "wb") as f:
        pickle.dump(jax_grads(case, data, x64=True), f)


# ------------------------------------------------------------------ port side


def port_grads(case: str, data: dict, x64: bool) -> dict:
    import contextlib

    import torch

    from chip_smoke import float64_render
    from ide3d_tpu_torch.io.from_jax import load_jax_clip, load_jax_params
    from ide3d_tpu_torch.models import clip as tclip
    from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.render.renderer import RenderParams
    from ide3d_tpu_torch.editing import latent_editor as le
    from ide3d_tpu_torch.train import pti, styleclip

    dt = torch.float64 if x64 else torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dt)

    context = float64_render if x64 else contextlib.nullcontext
    with context(), torch.enable_grad():
        # built inside the context: the modules read their compute dtype when made
        G = Ide3dGenerator(GeneratorConfig(**TINY, dtype="float32",
                                           render=RenderParams(img_size=8, num_steps=4)))
        load_jax_params(G, data["g_params"])
        G = G.eval().requires_grad_(False).to(dt)
        if case == "projector":
            w = t(data["w"]).requires_grad_(True)
            noise = {k: t(v).requires_grad_(True) for k, v in sorted(data["noise"].items())}
            feats = [f.detach() for f in pti.default_pyramid_feats(t(data["target"]))]
            loss, _ = pti.projector_loss(G, w, noise, t(data["c"]), feats, pti.ProjectorConfig())
            g = torch.autograd.grad(loss, [w, *noise.values()])
            return {"w": [g[0].double().numpy()], "noise": [x.double().numpy() for x in g[1:]]}
        m = load_jax_clip(tclip.CLIP(tclip.ClipConfig(**CLIP_CFG)), data["clip"]).eval()
        m = m.requires_grad_(False).to(dt)
        arc = load_jax_params(ArcFaceIRSE50(), data["arcface"]).eval().requires_grad_(False).to(dt)
        mapper = le.LevelsMapper(512, G.num_ws)
        load_jax_params(mapper, data["mapper"])
        mapper = mapper.to(dt)
        real_front = styleclip._front
        styleclip._front = lambda *a: real_front(*a).to(dt)
        try:
            loss, _ = styleclip.styleclip_loss(G, mapper, m, torch.from_numpy(data["tokens"]),
                                               t(data["w"]), styleclip.StyleClipConfig(lr=0.05,
                                                                                       batch_size=2),
                                               arc.embed_faces)
        finally:
            styleclip._front = real_front
        names = [n for n, _ in mapper.named_parameters()]
        g = torch.autograd.grad(loss, list(mapper.parameters()))
        by_name = dict(zip(names, g))
        # the JAX tree's order: group, fc, leaf sorted as key strings
        order = sorted(names, key=lambda n: "".join(f"['{p}']" for p in n.split(".")))
        return {"mapper": [by_name[n].double().numpy() for n in order]}


# ---------------------------------------------------------------------- inputs


def case_data(case: str) -> dict:
    """The fp32 trees and inputs of the case, as numpy, from the JAX inits
    and the tests' seeds."""
    import jax
    import jax.numpy as jnp

    from ide3d_tpu import render as jrender

    jax_, jG, jclip, JArcFace, jle = _jax_models("float32")
    np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    gp = jax.jit(jG.init)(jax.random.PRNGKey(0))
    if case == "projector":
        gp = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.full_like(x, 0.3) if path[-1].key == "noise_strength" else x, gp)
        gp = np_tree(gp)
        rng = np.random.RandomState(3)
        c = np.asarray(jrender.make_label_25(jrender.look_at_pose(
            np.pi / 2 + 0.2, np.pi / 2, [0.0, 0.0, 0.0], radius=2.7)), np.float32).reshape(1, 25)
        target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
        rng = np.random.RandomState(5)
        num_ws = jG.num_ws
        w = gp["mapping"]["w_avg"][None, None].repeat(num_ws, 1) + \
            rng.randn(1, num_ws, 512).astype(np.float32) * 0.3
        from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
        from ide3d_tpu_torch.render.renderer import RenderParams

        G = Ide3dGenerator(GeneratorConfig(**TINY, dtype="float32",
                                           render=RenderParams(img_size=8, num_steps=4)))
        noise = {k: rng.randn(*p.shape).astype(np.float32)
                 for k, p in G.synthesis.named_parameters() if k.endswith("noise_const")}
        return {"g_params": gp, "c": c, "target": target, "w": w.astype(np.float32),
                "noise": noise}
    from ide3d_tpu.train import styleclip as jstyleclip

    cfg = jstyleclip.StyleClipConfig(lr=0.05, batch_size=2)
    jmapper = jle.LevelsMapper(w_dim=512, num_ws=jG.num_ws)
    state = jstyleclip.init_styleclip_state(jmapper, jax.random.PRNGKey(2), cfg)
    w = np.asarray(jstyleclip.sample_latents(jG, gp, 2, jax.random.PRNGKey(3), cfg.truncation_psi))
    clip_p = jclip.CLIP(cfg=jclip.ClipConfig(**CLIP_CFG)).init(jax.random.PRNGKey(1))
    arc = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if path[-1].key == "weight" and x.ndim == 4 else x,
        JArcFace().init())
    tokens = jclip.SimpleTokenizer(merges=MERGES).tokenize(["low"], context_length=12)
    return {"g_params": np_tree(gp), "mapper": np_tree(state.mapper_params), "w": w,
            "clip": np_tree(clip_p), "arcface": np_tree(arc), "tokens": np.asarray(tokens)}


def measure(case: str) -> dict:
    data = case_data(case)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.pkl")
        with open(path, "wb") as f:
            pickle.dump(data, f)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--x64-worker", case, path],
                       cwd=ROOT, check=True, timeout=1800)
        with open(path + ".out", "rb") as f:
            jax64 = pickle.load(f)
    g = {"jax32": jax_grads(case, data, x64=False), "jax64": jax64,
         "port32": port_grads(case, data, x64=False), "port64": port_grads(case, data, x64=True)}
    pairs = (("jax32", "jax64"), ("port32", "port64"), ("jax64", "port64"), ("jax32", "port64"),
             ("port32", "jax64"), ("port32", "jax32"))
    return {"case": case, **{f"{a}_vs_{b}": gap(g[a], g[b]) for a, b in pairs}}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=["projector", "mapper", "both"], default="both")
    ap.add_argument("--x64-worker", nargs=2, metavar=("CASE", "DATA"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.x64_worker:
        jax_x64_worker(*args.x64_worker)
        return []
    import jax

    jax.config.update("jax_platforms", "cpu")
    rows = []
    for case in (("projector", "mapper") if args.case == "both" else (args.case,)):
        rows.append(measure(case))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
