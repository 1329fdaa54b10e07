"""The port's inversion (train/losses.py, train/pti.py and the run_pti,
latent_creator and infer_hybrid_encoder CLIs) against the JAX package, on the CPU.

The tiny preset of tests/test_train.py (32² out, 16² planes, 8² render, 4+4
samples), initialised by JAX and bridged through io/from_jax.py, fp32, at one
intra-op thread, with non-zero layer-noise strengths where the noise buffers
must take part (at the init's strength 0 their gradient is 0 in both
packages). The draws cannot match (torch.Generator against jax.random), so
the tests inject them: the w statistics' z, the projector's noise init and
the locality samples come from the JAX package's own keys, and the w
exploration noise is set to 0 (initial_noise_factor=0). The CLIs draw on
their own and run on different random generators (`random:0:tiny` is each
package's own init), so they are held to their files and finite values, and
where no draw enters (the e4e one-shot latents) to the JAX CLI's output.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import PIL.Image
import pytest
import torch

from ide3d_tpu import render as jrender
from ide3d_tpu.apps import latent_creator as jlatent_creator
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.train import losses as jL
from ide3d_tpu.train import pti as jpti
from ide3d_tpu_torch.apps import common, infer_hybrid_encoder, latent_creator, run_pti
from ide3d_tpu_torch.io.checkpoint import save_checkpoint
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.arcface import reset_norms
from ide3d_tpu_torch.models.e4e import E4eEncoder
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.parallel import mesh
from ide3d_tpu_torch.render.renderer import RenderParams
from ide3d_tpu_torch.train import losses as L
from ide3d_tpu_torch.train import pti
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
R = 32
# fp32 renders and gradients through the same graph, the order of sums apart
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported, and a test
    worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def rel_close(got, ref, tol, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (name, err, scale)


def _noise_strength(params, v):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, v) if path[-1].key == "noise_strength" else x, params)


def _bridge(strength):
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    gp = _noise_strength(jax.jit(jG.init)(jax.random.PRNGKey(0)), strength)
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, gp))
    return jG, gp, G.eval()


@pytest.fixture(scope="module")
def bridged():
    """(JAX G, params, port G) with layer-noise strength 0.3: the noise enters."""
    return _bridge(0.3)


@pytest.fixture(scope="module")
def bridged_init_noise():
    """The same at the init's noise strength 0 (see test_pivotal_tune_matches_jax)."""
    return _bridge(0.0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    c = np.asarray(jrender.make_label_25(jrender.look_at_pose(
        np.pi / 2 + 0.2, np.pi / 2, [0.0, 0.0, 0.0], radius=2.7)), np.float32).reshape(1, 25)
    return {"c": c, "target": rng.uniform(-1, 1, (1, R, R, 3)).astype(np.float32),
            "rng": rng}


# ------------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 8, 8, 3).astype(np.float32), rng.randn(2, 8, 8, 3).astype(np.float32)
    for beta in (1.0, 0.5):
        rel_close(L.smooth_l1(t(x), t(y), beta), jL.smooth_l1(x, y, beta), 1e-6, "smooth_l1")
    rel_close(L.l2(t(x), t(y)), jL.l2(x, y), 1e-6, "l2")
    logits, ids = rng.randn(2, 8, 8, 20).astype(np.float32), rng.randint(0, 20, (2, 8, 8))
    rel_close(L.cross_entropy_seg(t(logits), torch.from_numpy(ids)),
              jL.cross_entropy_seg(logits, ids), 1e-6, "cross_entropy_seg")
    rel_close(L.multiscale_feature_loss(pti.default_pyramid_feats, t(x), t(y)),
              jL.multiscale_feature_loss(jpti.default_pyramid_feats, x, y), 1e-6, "multiscale")
    m = rng.randn(8 * 8 * 3, 16).astype(np.float32)
    rel_close(L.cosine_id_loss(lambda a: a.reshape(2, -1) @ t(m), t(x), t(y)),
              jL.cosine_id_loss(lambda a: a.reshape(2, -1) @ m, x, y), 1e-6, "cosine_id")


def test_feature_loss_detaches_its_target():
    x = torch.randn(1, 8, 8, 3, requires_grad=True)
    y = torch.randn(1, 8, 8, 3, requires_grad=True)
    L.multiscale_feature_loss(pti.default_pyramid_feats, x, y).backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0 and y.grad is None
    L.cosine_id_loss(lambda a: a.reshape(1, -1), x, y).backward()
    assert y.grad is None


# ----------------------------------------------------- projector machinery


def test_noise_machinery_and_schedule_match_jax(bridged):
    jG, gp, G = bridged
    paths = [".".join(p) for p in jpti.noise_buffer_paths(gp["synthesis"])]
    assert sorted(pti.noise_buffer_paths(G.synthesis)) == sorted(paths)
    rng = np.random.RandomState(1)
    noise = {k: rng.randn(*np.asarray(jpti._tree_get(gp["synthesis"], k.split("."))).shape)
             .astype(np.float32) * 0.7 + 0.1 for k in paths}
    assert {n.shape[0] for n in noise.values()} >= {4, 16, 32}  # single and multi-scale buffers
    jnoise = {k: jnp.asarray(v) for k, v in noise.items()}
    rel_close(pti.noise_regularization({k: t(v) for k, v in noise.items()}),
              jax.jit(jpti.noise_regularization)(jnoise), 1e-5, "reg")
    got = pti.normalize_noise({k: t(v) for k, v in noise.items()})
    ref = jax.jit(jpti.normalize_noise)(jnoise)
    for k in paths:
        rel_close(got[k], ref[k], 1e-5, k)
    cfg = pti.ProjectorConfig()
    jcfg = jpti.ProjectorConfig()
    for step in (0, 1, 10, 22, 100, 337, 449):
        np.testing.assert_allclose(pti.projector_schedule(step, cfg, 2.5),
                                   jpti.projector_schedule(step, jcfg, 2.5), rtol=1e-12)


def test_compute_w_stats_matches_jax_given_z(bridged, inputs):
    jG, gp, G = bridged
    key = jax.random.PRNGKey(4)
    z = np.asarray(jax.random.normal(key, (32, 512)))
    w_avg, w_std = jpti.compute_w_stats(jG, gp, jnp.asarray(inputs["c"]), key, n=32)
    got_avg, got_std = pti.compute_w_stats(G, t(inputs["c"]), z=t(z))
    rel_close(got_avg, w_avg, 1e-5, "w_avg")
    np.testing.assert_allclose(got_std, float(w_std), rtol=1e-5)
    # the reference's w_std: sum over every element / the sample count
    ws = G.mapping(t(z), t(inputs["c"]).expand(32, -1))[:, 0].detach().numpy()
    np.testing.assert_allclose(got_std, np.sqrt(((ws - ws.mean(0)) ** 2).sum() / 32), rtol=1e-5)


def test_default_pyramid_feats_match_jax(inputs):
    for a, b in zip(pti.default_pyramid_feats(t(inputs["target"])),
                    jpti.default_pyramid_feats(jnp.asarray(inputs["target"]))):
        rel_close(a, b, 1e-5, "pyramid level")


def _projector_start(G, rng):
    w = np.asarray(G.mapping.w_avg)[None, None].repeat(G.num_ws, 1) + \
        rng.randn(1, G.num_ws, 512).astype(np.float32) * 0.3
    noise = {k: rng.randn(*p.shape).astype(np.float32) for k, p in G.synthesis.named_parameters()
             if k.endswith("noise_const")}
    return w, noise


@pytest.fixture(scope="module")
def projector_case(bridged, inputs):
    """The projector step's start (w+, noise), the JAX loss and gradients at
    it, the loss written from the JAX package's public pieces (its
    project_w_plus loss), and the port's loss and gradients there."""
    jG, gp, G = bridged
    cfg = pti.ProjectorConfig()
    w, noise = _projector_start(G, np.random.RandomState(5))
    c, target = inputs["c"], inputs["target"]
    t_feats = [jax.lax.stop_gradient(f) for f in jpti.default_pyramid_feats(jnp.asarray(target))]

    def jloss(varz):
        sp = jpti.merge_noise(gp["synthesis"], varz["noise"])
        img = jG.synthesis(sp, varz["w"], jnp.asarray(c), noise_mode="const")
        dist = sum(jnp.mean(jnp.square(a - b)) for a, b in zip(jpti.default_pyramid_feats(img), t_feats))
        return dist + cfg.noise_reg_weight * jpti.noise_regularization(varz["noise"])

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(
        {"w": jnp.asarray(w), "noise": {k: jnp.asarray(v) for k, v in noise.items()}})
    return w, noise, ref_loss, ref_g, _port_projector_grads(G, w, noise, inputs)


@torch.enable_grad()  # a module fixture calls it, outside the per-test _autograd_on
def _port_projector_grads(G, w, noise, inputs):
    cfg = pti.ProjectorConfig()
    dt = next(G.parameters()).dtype
    tw = torch.as_tensor(w, dtype=dt).requires_grad_(True)
    tn = {k: torch.as_tensor(v, dtype=dt).requires_grad_(True) for k, v in noise.items()}
    feats = [f.detach() for f in pti.default_pyramid_feats(torch.as_tensor(inputs["target"], dtype=dt))]
    loss, _ = pti.projector_loss(G, tw, tn, torch.as_tensor(inputs["c"], dtype=dt), feats, cfg)
    return loss, torch.autograd.grad(loss, [tw, *tn.values()])


def test_projector_step_loss_and_gradients_match_jax(bridged, inputs, projector_case):
    """One projector step's loss and its w+ and noise gradients, with the JAX
    loss written from the JAX package's public pieces (its project_w_plus loss)."""
    jG, gp, G = bridged
    w, noise, ref_loss, ref_g, (loss, grads) = projector_case
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    rel_close(grads[0], ref_g["w"], GRAD_TOL, "dw")
    got_n = np.concatenate([g.numpy().ravel() for g in grads[1:]])
    ref_n = np.concatenate([np.asarray(ref_g["noise"][k]).ravel() for k in noise])
    assert float(np.abs(ref_n).max()) > 0  # the noise takes part at strength 0.3
    rel_close(got_n, ref_n, GRAD_TOL, "dnoise")
    assert all(p.grad is None for p in G.parameters())  # G's own gradients untouched


def test_projector_fp32_gradient_gap_is_jaxs(bridged, inputs, projector_case):
    """The fp32 gradient gap (ROADMAP Queue 3): the JAX package's fp32 w+ and
    noise gradients and the port's, each against the port in float64
    (chip_smoke.float64_render), which is the JAX package's own float64 here
    to 1e-14 (tools/fp32_grad_gap.py --case projector runs JAX with x64).
    max |g32 - g64| / max |g64| over both groups: JAX's 7.5e-6, the port's
    1.2e-6; the port's is at most twice JAX's."""
    from chip_smoke import float64_render

    jG, gp, G = bridged
    w, noise, _, ref_g, (_, g32) = projector_case
    with float64_render():
        G64 = Ide3dGenerator(G.cfg)  # built inside: the modules read their compute dtype when made
        G64.load_state_dict(G.state_dict())
        _, g64 = _port_projector_grads(G64.eval().double(), w, noise, inputs)
    ref = [g.double().numpy() for g in g64]
    jax32 = [np.asarray(ref_g["w"], np.float64)] + [np.asarray(ref_g["noise"][k], np.float64)
                                                    for k in noise]

    def gap(got):
        return max(float(np.abs(a - b).max()) / float(np.abs(b).max()) for a, b in zip(got, ref))

    jax_gap, port_gap = gap(jax32), gap([g.double().numpy() for g in g32])
    assert all(np.isfinite(r).all() for r in ref) and float(np.abs(ref[1]).max()) > 0
    assert 0 < jax_gap < 1e-4 and 0 < port_gap < 1e-4, (jax_gap, port_gap)
    assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)


def test_three_projector_steps_match_jax(bridged, inputs):
    """project_w_plus for 3 steps (the lr ramp, Adam, the noise normalization),
    the JAX package's draws injected: its w statistics' z and its noise init from
    the same key; the w exploration noise off."""
    jG, gp, G = bridged
    cfg = pti.ProjectorConfig(num_steps=3, w_avg_samples=16, initial_noise_factor=0.0)
    key = jax.random.PRNGKey(7)
    k_stats, k_noise, _ = jax.random.split(key, 3)
    z = np.asarray(jax.random.normal(k_stats, (16, 512)))
    init = {".".join(p): np.asarray(jax.random.normal(
        jax.random.fold_in(k_noise, i), jpti._tree_get(gp["synthesis"], p).shape, jnp.float32))
        for i, p in enumerate(jpti.noise_buffer_paths(gp["synthesis"]))}
    ref_w, ref_noise = jpti.project_w_plus(
        jG, gp, jnp.asarray(inputs["target"]), jnp.asarray(inputs["c"]),
        jpti.ProjectorConfig(num_steps=3, w_avg_samples=16, initial_noise_factor=0.0),
        key=key, return_noise=True)
    before = {k: v.detach().clone() for k, v in G.state_dict().items()}
    w, noise = pti.project_w_plus(G, t(inputs["target"]), t(inputs["c"]), cfg, z_stats=t(z),
                                  initial_noise={k: t(v) for k, v in init.items()},
                                  return_noise=True)
    rel_close(w, ref_w, 1e-5, "w")
    for k in init:
        rel_close(noise[k], ref_noise[k], 1e-4, k)
        assert not np.allclose(noise[k].numpy(), init[k])  # optimized, then renormalized
    assert all(torch.equal(v, G.state_dict()[k]) for k, v in before.items())  # G not written


def test_projector_draws_from_its_generator(bridged, inputs):
    """The random path by itself: the same seed gives the same w, the loss falls."""
    jG, gp, G = bridged
    cfg = pti.ProjectorConfig(num_steps=6, w_avg_samples=32, lr=0.05)
    runs = [pti.project_w_plus(G, t(inputs["target"]), t(inputs["c"]), cfg,
                               generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all()
    w_avg, _ = pti.compute_w_stats(G, t(inputs["c"]), 32, torch.Generator().manual_seed(1))
    feats = [f.detach() for f in pti.default_pyramid_feats(t(inputs["target"]))]
    with torch.no_grad():
        start = pti.projector_loss(G, w_avg[:, None].repeat(1, G.num_ws, 1), {}, t(inputs["c"]),
                                   feats, cfg)[1]
        end = pti.projector_loss(G, runs[0], {}, t(inputs["c"]), feats, cfg)[1]
    assert float(end) < float(start)


# ------------------------------------------------------------ pivotal tuning


def _render(G, w, c):
    with torch.no_grad():
        return G.synthesis(w, c, noise_mode="const").numpy()


class _FrozenMaskOptax:
    """optax, with `masked` leaving the masked-out leaves unchanged: the JAX
    package's PTI masks the noise buffers out of Adam with optax.masked, which
    passes their raw gradient through as their update, so from the second step
    on (once the trained noise strengths are non-zero) its buffers move by the
    gradient itself. The reference keeps them as buffers, unchanged, and so
    does the port (ROADMAP Queue 3; test_pti_leaves_noise_buffers_out_of_adam
    runs the JAX loop as it is)."""

    def __getattr__(self, name):
        return getattr(optax, name)

    @staticmethod
    def masked(inner, mask):
        frozen = jax.tree_util.tree_map(lambda m: not m, mask)
        return optax.chain(optax.masked(inner, mask), optax.masked(optax.set_to_zero(), frozen))


@pytest.mark.parametrize("join_view,steps,repaired", [(False, 3, True), (True, 3, True),
                                                     (False, 1, False)],
                         ids=["plain", "join_view", "plain_one_step_unrepaired"])
def test_pivotal_tune_matches_jax(bridged_init_noise, inputs, join_view, steps, repaired,
                                  monkeypatch):
    """PTI steps, plain and with the mirrored view: the tuned G's render of the
    pivot against the JAX package's. Over 3 steps the JAX loop's noise buffers
    are frozen as the reference's (_FrozenMaskOptax); one step is held to the
    JAX package as it is: at the init's noise strength 0 the buffers' gradient
    is 0, so neither package moves them in the first step."""
    jG, gp, G = bridged_init_noise
    if repaired:
        monkeypatch.setattr(jpti, "optax", _FrozenMaskOptax())
    w = np.asarray(G.mapping(t(np.random.RandomState(2).randn(1, 512)), t(inputs["c"])).detach())
    jcfg = jpti.PtiConfig(max_steps=steps, lpips_threshold=-1.0, join_view=join_view)
    tuned_p = jpti.pivotal_tune(jG, gp, jnp.asarray(w), jnp.asarray(inputs["target"]),
                                jnp.asarray(inputs["c"]), jcfg)
    ref = np.asarray(jax.jit(lambda sp: jG.synthesis(
        sp, jnp.asarray(w), jnp.asarray(inputs["c"]), noise_mode="const"))(tuned_p["synthesis"]))
    if not repaired:  # the JAX package's own loop left its buffers as they were
        for path in jpti.noise_buffer_paths(gp["synthesis"]):
            np.testing.assert_array_equal(np.asarray(jpti._tree_get(tuned_p["synthesis"], path)),
                                          np.asarray(jpti._tree_get(gp["synthesis"], path)))
    cfg = pti.PtiConfig(max_steps=steps, lpips_threshold=-1.0, join_view=join_view)
    before = _render(G, t(w), t(inputs["c"]))
    tuned = pti.pivotal_tune(G, t(w), t(inputs["target"]), t(inputs["c"]), cfg)
    got = _render(tuned, t(w), t(inputs["c"]))
    rel_close(got, ref, 1e-4, "tuned render")
    assert np.abs(got - before).max() > 1e-3  # the tuning moved the render
    np.testing.assert_array_equal(_render(G, t(w), t(inputs["c"])), before)  # G not changed


def test_pti_early_stop_reads_the_main_view_lpips(bridged, inputs):
    jG, gp, G = bridged
    w = G.mapping(t(np.random.RandomState(2).randn(1, 512)), t(inputs["c"])).detach()
    seen = []

    def lpips(x, y):
        seen.append(1)
        return pti.pyramid_distance(x, y)

    pti.pivotal_tune(G, w, t(inputs["target"]), t(inputs["c"]),
                     pti.PtiConfig(max_steps=5, lpips_threshold=1e9, join_view=True), lpips_fn=lpips)
    assert len(seen) == 2  # one step: the main view and the mirrored view, then the stop


def test_pti_leaves_noise_buffers_out_of_adam(bridged, inputs):
    """The port tunes every synthesis parameter but the noise buffers, which
    stay as they were (the reference's buffers). The JAX loop masks them out of
    Adam with optax.masked, which passes a masked leaf's raw gradient through
    as its update, so its buffers move by the gradient itself (ROADMAP Queue 3;
    shown here on optax.masked as the JAX loop builds it)."""
    jG, gp, G = bridged
    w = G.mapping(t(np.random.RandomState(2).randn(1, 512)), t(inputs["c"])).detach()
    tuned = pti.pivotal_tune(G, w, t(inputs["target"]), t(inputs["c"]),
                             pti.PtiConfig(max_steps=2, lpips_threshold=-1.0))
    names = pti.noise_buffer_paths(G.synthesis)
    old, new = dict(G.synthesis.named_parameters()), dict(tuned.synthesis.named_parameters())
    assert all(torch.equal(old[k], new[k]) for k in names)
    assert any(not torch.equal(old[k], new[k]) for k in new if k not in names)
    opt = optax.masked(optax.adam(3e-4), {"w": True, "noise_const": False})
    grads = {"w": jnp.ones(2), "noise_const": jnp.full(2, 7.0)}
    updates, _ = opt.update(grads, opt.init(grads))
    np.testing.assert_array_equal(np.asarray(updates["noise_const"]), 7.0)  # the raw gradient


def test_locality_loss_matches_jax_given_w_samples(bridged, inputs):
    """The ball-holder term and its gradient in the tuned synthesis parameters,
    the JAX package's samples (its key's z, mapped at psi 0.5) given to the port."""
    jG, gp, G = bridged
    c = inputs["c"]
    rng = np.random.RandomState(6)
    w = np.asarray(G.mapping(t(rng.randn(1, 512)), t(c)).detach())
    tuned_p = jax.tree_util.tree_map(  # a tuned G: every synthesis leaf moved a little
        lambda x: np.asarray(x) + np.float32(0.01) * np.asarray(rng.randn(*x.shape), x.dtype),
        gp["synthesis"])
    cfg = jpti.PtiConfig(locality_samples=2)
    key = jax.random.PRNGKey(9)
    z = jax.random.normal(key, (2, 512))
    w_samples = jax.jit(lambda p, z, c: jG.mapping(p, z, c, truncation_psi=0.5))(
        gp["mapping"], z, jnp.broadcast_to(jnp.asarray(c), (2, 25)))

    def lp(x, y):
        return jL.multiscale_feature_loss(jpti.default_pyramid_feats, x, y)

    ref, ref_g = jax.jit(jax.value_and_grad(lambda sp: jpti.locality_loss(
        jG, sp, gp, jnp.asarray(w), jnp.asarray(c), key, cfg, lp)))(tuned_p)
    Gt = Ide3dGenerator(G.cfg)
    load_jax_params(Gt, jax.tree_util.tree_map(np.asarray, {**gp, "synthesis": tuned_p}))
    got = pti.locality_loss(Gt, G, t(w), t(c), pti.PtiConfig(locality_samples=2),
                            pti.pyramid_distance, w_samples=t(w_samples))
    grads = torch.autograd.grad(got, list(Gt.synthesis.parameters()), allow_unused=True)
    # the term is the small difference of two renders ~40 in scale: their fp32
    # rounding (~1e-5 of the scale) enters it relative to the difference
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-4)
    # the JAX gradient tree in the port's layouts, through the bridge
    probe = Ide3dGenerator(G.cfg)
    load_jax_params(probe, jax.tree_util.tree_map(np.asarray, {**gp, "synthesis": ref_g}))
    got_all = np.concatenate([np.zeros(p.numel(), np.float32) if g is None else g.numpy().ravel()
                              for g, p in zip(grads, Gt.synthesis.parameters())])
    ref_all = np.concatenate([p.detach().numpy().ravel() for p in probe.synthesis.parameters()])
    rel_close(got_all, ref_all, GRAD_TOL, "locality gradient")


def test_flip_label_25():
    c = np.arange(25, dtype=np.float32)[None] + 1
    np.testing.assert_array_equal(pti.flip_label_25(t(c)).numpy(), np.asarray(jpti.flip_label_25(c)))


# ---------------------------------------------------------------------- CLIs


def _write_images(root, n, size=R, masks=False):
    rng = np.random.RandomState(11)
    os.makedirs(os.path.join(root, "imgs"))
    if masks:
        os.makedirs(os.path.join(root, "masks"))
    for i in range(n):
        PIL.Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            os.path.join(root, "imgs", f"f{i}.png"))
        if masks:
            PIL.Image.fromarray(rng.randint(0, 19, (size, size), np.uint8)).save(
                os.path.join(root, "masks", f"f{i}.png"))
    return os.path.join(root, "imgs")


def test_run_pti_cli_writes_its_outputs(tmp_path, capsys):
    """run_pti at random:0:tiny on the CPU: per image the pivot, the label, the
    tuned snapshot (it reloads through load_generator and reproduces the
    compare image's render within 1 uint8 level), the compare image; the
    join-view + locality run with its orbit video; the multi-id run."""
    imgs = _write_images(str(tmp_path), 2)
    out = str(tmp_path / "pti")
    common_args = ["--network", "random:0:tiny", "--projector-steps", "3", "--pti-steps", "2",
                   "--lpips-threshold", "0", "--device", "cpu"]
    run_pti.main(["--images", imgs, "--outdir", out] + common_args)
    for name in ("f0", "f1"):
        ws = np.load(os.path.join(out, f"{name}.npz"))["ws"]
        c = np.load(os.path.join(out, f"{name}_label.npz"))["c"]
        assert ws.shape == (1, 12, 512) and np.isfinite(ws).all() and c.shape == (1, 25)
        G = common.load_generator(os.path.join(out, f"model_{name}"), "cpu")
        with torch.no_grad():
            img = G.synthesis(torch.from_numpy(ws), torch.from_numpy(c), noise_mode="const")
        want = np.rint((img[0].numpy() + 1) * 127.5).clip(0, 255)
        pair = np.asarray(PIL.Image.open(os.path.join(out, f"{name}_compare.png")), np.float32)
        assert pair.shape == (R, 2 * R, 3)  # target | reconstruction
        assert np.abs(pair[:, R:] - want).max() <= 1
    assert "projector step 0" in capsys.readouterr().out

    out2 = str(tmp_path / "pti_jv")
    run_pti.main(["--images", os.path.join(imgs, "f0.png"), "--outdir", out2, "--join-view",
                  "--use-locality", "--video", "--no-noise-opt"] + common_args)
    files = os.listdir(out2)
    assert {"f0.npz", "f0_label.npz", "f0_compare.png", "model_f0"} <= set(files)
    assert any(f.startswith("f0_orbit.") for f in files)
    out3 = str(tmp_path / "pti_multi")
    run_pti.main(["--images", imgs, "--outdir", out3, "--multi-id"] + common_args)
    assert {"model_multi_id", "f0_compare.png", "f1_compare.png"} <= set(os.listdir(out3))


@pytest.fixture(scope="module")
def e4e_ckpt(tmp_path_factory):
    """An e4e .pt in the pSp layout ('state_dict' with encoder.* names,
    'latent_avg', the training 'opts' Namespace) at stylegan_size 4 (2 rows,
    the smallest file; the tiny G takes 12, so the last row repeats). Its
    weights follow the JAX package's e4e init with its convs at half the
    init's std (N(0, 0.025²) convs, N(0, 1) head linears, zero biases, identity
    BN, PReLU 0.25), drawn from a torch.Generator: at the init's std the
    IR-SE50 body grows activations ~1e6-fold and fp32 rounding takes over
    (tests/test_torch_face_nets.py)."""
    import argparse

    e = E4eEncoder(4, "e4e")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in e.named_parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.025)
            elif name.endswith("linear.weight"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif name.endswith("bias"):
                p.zero_()
        reset_norms(e)
    folder = tmp_path_factory.mktemp("e4e")
    path = str(folder / "e4e.pt")
    torch.save({"state_dict": {f"encoder.{k}": v for k, v in e.state_dict().items()},
                "latent_avg": torch.linspace(-0.5, 0.5, 512),
                "opts": argparse.Namespace(encoder_type="Encoder4Editing")}, path)
    yield path
    shutil.rmtree(folder, ignore_errors=True)  # ~200 MB; tests/torch_tmp.py says why


def test_latent_creator_e4e_matches_jax_and_projects(tmp_path, e4e_ckpt):
    """latent_creator --e4e (one-shot, no draws) against the JAX CLI on the
    same file and image; then the projector leg for its files."""
    imgs = _write_images(str(tmp_path), 1)
    ckpt = e4e_ckpt
    jlatent_creator.main(["--network", "random:0:tiny", "--images", imgs, "--e4e", ckpt,
                          "--outdir", str(tmp_path / "jax")])
    latent_creator.main(["--network", "random:0:tiny", "--images", imgs, "--e4e", ckpt,
                         "--outdir", str(tmp_path / "port"), "--device", "cpu"])
    ref = np.load(tmp_path / "jax" / "f0.npz")["ws"]
    got = np.load(tmp_path / "port" / "f0.npz")["ws"]
    rel_close(got, ref, 1e-5, "e4e latents")
    np.testing.assert_array_equal(got[:, 2:], np.repeat(got[:, 1:2], 10, axis=1))

    latent_creator.main(["--network", "random:0:tiny", "--images", imgs, "--steps", "2",
                         "--outdir", str(tmp_path / "proj"), "--device", "cpu"])
    assert np.isfinite(np.load(tmp_path / "proj" / "f0.npz")["ws"]).all()
    assert (tmp_path / "proj" / "index.json").exists()


def test_run_pti_e4e_and_encoder_warm_starts(tmp_path, monkeypatch, e4e_ckpt):
    """run_pti --e4e starts the projector at the e4e pivot; --encoder with
    --masks at E's code + w_avg; infer_hybrid_encoder writes its three files."""
    imgs = _write_images(str(tmp_path), 1, masks=True)
    ckpt = e4e_ckpt
    G = common.load_generator("random:0:tiny", "cpu")
    pivot, report = common.make_e4e_pivot_fn(G, ckpt, device="cpu")
    assert report.variant == "e4e" and report.style_count == 2
    starts = []
    real = pti.project_w_plus

    def spy(G, target, c, cfg, initial_w=None, **kw):
        starts.append(initial_w)
        return real(G, target, c, cfg, initial_w=initial_w, **kw)

    monkeypatch.setattr(pti, "project_w_plus", spy)
    base = ["--network", "random:0:tiny", "--images", imgs, "--projector-steps", "1",
            "--pti-steps", "1", "--device", "cpu"]
    run_pti.main(base + ["--e4e", ckpt, "--outdir", str(tmp_path / "a")])
    enc = str(tmp_path / "enc")
    E = infer_hybrid_encoder.build_encoder(G, "random:3", "cpu")
    save_checkpoint(enc, {"E": E.state_dict()})
    run_pti.main(base + ["--encoder", enc, "--masks", str(tmp_path / "masks"),
                         "--outdir", str(tmp_path / "b")])
    target = torch.from_numpy(infer_hybrid_encoder.load_image(os.path.join(imgs, "f0.png"), R))[None]
    torch.testing.assert_close(starts[0], pivot(target))
    mask = torch.from_numpy(infer_hybrid_encoder.load_mask(str(tmp_path / "masks" / "f0.png"), R))
    with torch.no_grad():
        want = E(target, torch.nn.functional.one_hot(mask[None], 19).float() * 2 - 1) \
            + G.mapping.w_avg[None, None]
    torch.testing.assert_close(starts[1], want)

    infer_hybrid_encoder.main(["--network", "random:0:tiny", "--encoder", enc,
                               "--img", os.path.join(imgs, "f0.png"),
                               "--mask", str(tmp_path / "masks" / "f0.png"),
                               "--outdir", str(tmp_path / "inf"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "inf")) == ["rec_ws.npz", "recon.png", "recon_seg.png"]
    torch.testing.assert_close(torch.from_numpy(np.load(tmp_path / "inf" / "rec_ws.npz")["ws"]), want)


def test_load_image_and_mask_match_jax(tmp_path):
    from ide3d_tpu.apps import infer_hybrid_encoder as jinfer

    rng = np.random.RandomState(0)
    PIL.Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(tmp_path / "a.png")
    PIL.Image.fromarray(rng.randint(0, 19, (40, 40), np.uint8)).save(tmp_path / "m.png")
    np.testing.assert_array_equal(infer_hybrid_encoder.load_image(str(tmp_path / "a.png"), 32),
                                  jinfer.load_image(str(tmp_path / "a.png"), 32))
    np.testing.assert_array_equal(infer_hybrid_encoder.load_mask(str(tmp_path / "m.png"), 32),
                                  jinfer.load_mask(str(tmp_path / "m.png"), 32))


class _Stop(Exception):
    pass


def test_inversion_entry_points_reach_the_cpu_only_when_asked(monkeypatch, tmp_path):
    """Each entry point builds its networks on the card unless --device cpu."""
    from ide3d_tpu_torch.apps import calc_losses_on_images, finetune_hybrid_encoder, \
        train_hybrid_encoder

    seen = []

    def fake_load(network, device="cuda"):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(common, "load_generator", fake_load)
    # The data-parallel CLIs load on their rank's device: a group of one on the
    # device type the CLI asks for (here without a process group)
    monkeypatch.setattr(mesh, "launch", lambda fn, world, device_type, *args, **kw:
                        fn(mesh.Group(device=torch.device(device_type)), *args))
    imgs = _write_images(str(tmp_path), 1)
    runs = {
        run_pti: ["--network", "x", "--images", imgs, "--outdir", "o"],
        latent_creator: ["--network", "x", "--images", imgs, "--outdir", "o"],
        infer_hybrid_encoder: ["--network", "x", "--img", "i", "--outdir", "o"],
        train_hybrid_encoder: ["--network", "x", "--outdir", str(tmp_path / "o")],
        finetune_hybrid_encoder: ["--network", "x", "--img", "i", "--mask", "m",
                                  "--target-code", "t", "--outdir", "o"],
    }
    for mod, argv in runs.items():
        for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            with pytest.raises(_Stop):
                mod.main(argv + extra)
            assert seen.pop() == torch.device(want), mod.__name__

    def fake_as_tensor(data, dtype=None, device=None):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(torch, "as_tensor", fake_as_tensor)
    for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
        with pytest.raises(_Stop):
            calc_losses_on_images.main(["--mode", "l2", "--data-a", imgs, "--data-b", imgs] + extra)
        assert seen.pop() == torch.device(want)


def test_inversion_modules_leave_jax_out():
    code = ("import sys, ide3d_tpu_torch.train, ide3d_tpu_torch.apps.run_pti, "
            "ide3d_tpu_torch.apps.latent_creator, ide3d_tpu_torch.apps.infer_hybrid_encoder, "
            "ide3d_tpu_torch.apps.train_hybrid_encoder, ide3d_tpu_torch.apps.finetune_hybrid_encoder, "
            "ide3d_tpu_torch.apps.calc_losses_on_images, ide3d_tpu_torch.models.arcface, "
            "ide3d_tpu_torch.models.bisenet, ide3d_tpu_torch.models.e4e; "
            "print('jax' in sys.modules, 'ide3d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.split() == ["False", "False"]
