"""The port's latent editing (editing/latent_editor.py, train/styleclip.py,
train/nada.py and the styleclip_edit, train_styleclip_mapper, train_nada,
edit_comparison and experiment_runner CLIs) against the JAX package, on the CPU.

The tiny G of tests/test_train.py (32² out, 8² render, 4+4 samples),
initialised by JAX and bridged through io/from_jax.py, fp32, at one intra-op
thread; the tiny CLIP of tests/test_styleclip.py and ArcFace (its convs at
half the JAX init's std, as tests/test_torch_face_nets.py runs it) bridged
the same way. The draws cannot match (torch.Generator against jax.random), so
the tests inject them: GANSpace's z and the mapper's latents come from the
JAX package's keys, the mapper's weights from its init. NADA's renders draw
at random in both packages; its parity test renders them deterministically
in both (noise_mode 'const' forced) and starts the trained copy off the
frozen one: at step 0 the copies are equal, and the loss then reads
whatever rounding tells two renders apart (the port's renders are bit-equal
there: test_nada_shares_draws_between_its_renders). CLIs that draw run on their
own and are held to their files, finite values and what must not move.
"""

import glob
import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import ide3d_tpu.apps.common as jcommon
import ide3d_tpu_torch.apps.common as tcommon
from ide3d_tpu import render as jrender
from ide3d_tpu.editing import latent_editor as jle
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models import clip as jclip
from ide3d_tpu.models.arcface import ArcFaceIRSE50 as JArcFace
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.train import nada as jnada
from ide3d_tpu.train import styleclip as jstyleclip
from ide3d_tpu_torch.apps import (edit_comparison, experiment_runner, styleclip_edit, train_nada,
                                  train_styleclip_mapper)
from ide3d_tpu_torch.editing import latent_editor as le
from ide3d_tpu_torch.io.from_jax import load_jax_clip, load_jax_params
from ide3d_tpu_torch.models import clip as tclip
from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator, Ide3dSynthesisNetwork
from ide3d_tpu_torch.render.renderer import RenderParams
from ide3d_tpu_torch.train import nada, styleclip
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
CLIP_CFG = dict(embed_dim=16, image_resolution=32, vision_layers=1, vision_width=32,
                vision_patch_size=8, context_length=12, vocab_size=520, transformer_width=32,
                transformer_layers=1, head_dim=16)
MERGES = [("l", "o"), ("lo", "w</w>")]
TOL = 1e-5  # fp32 forwards, the order of sums apart
STEP_TOL = 1e-4  # one optimizer step through G, CLIP and ArcFace


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported, and a test
    worker imports every module."""
    with torch.enable_grad():
        yield


def rel_close(got, ref, tol, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * max(scale, 1e-30), (name, err, scale)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def bridged():
    """(JAX G, its params, the port's G with the same weights)."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, _np(params))
    return jG, params, G.eval()


@pytest.fixture(scope="module")
def clip_pair():
    jm = jclip.CLIP(cfg=jclip.ClipConfig(**CLIP_CFG))
    p = jm.init(jax.random.PRNGKey(1))
    m = load_jax_clip(tclip.CLIP(tclip.ClipConfig(**CLIP_CFG)), _np(p))
    return jm, p, m.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def arcface():
    jnet = JArcFace()
    tree = jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if path[-1].key == "weight" and x.ndim == 4 else x, jnet.init())
    net = load_jax_params(ArcFaceIRSE50(), _np(tree)).eval().requires_grad_(False)
    return jnet, tree, net


def _front(n):
    return np.broadcast_to(jrender.CANONICAL_POSE_25, (n, 25)).astype(np.float32)


# ------------------------------------------------------------ latent editor


def test_ganspace_pca_matches_jax_given_z(bridged):
    jG, params, G = bridged
    key = jax.random.PRNGKey(3)
    want = jle.compute_ganspace_pca(jG, params, n_samples=64, key=key, n_components=5)
    z = np.asarray(jax.random.normal(key, (64, jG.cfg.z_dim)))
    got = le.compute_ganspace_pca(G, n_components=5, z=torch.from_numpy(z))
    rel_close(got["mean"], want["mean"], TOL, "mean")
    rel_close(got["std"], want["std"], 1e-4, "std")
    sign = np.sign((got["comp"] * want["comp"]).sum(-1, keepdims=True))
    rel_close(got["comp"] * sign, want["comp"], 1e-4, "components up to sign")
    g2 = le.compute_ganspace_pca(G, n_samples=64, n_components=5,
                                 generator=torch.Generator().manual_seed(0))
    assert g2["comp"].shape == (5, G.w_dim) and np.isfinite(g2["comp"]).all()


def test_mapping_broadcast_false_matches_jax(bridged):
    jG, params, G = bridged
    z = np.random.RandomState(4).randn(3, 512).astype(np.float32)
    with torch.no_grad():
        for psi in (1.0, 0.7):
            got = G.mapping(torch.from_numpy(z), torch.from_numpy(_front(3)), truncation_psi=psi,
                            truncation_cutoff=2, broadcast=False)
            want = jG.mapping(params["mapping"], jnp.asarray(z), jnp.asarray(_front(3)),
                              truncation_psi=psi, truncation_cutoff=2, broadcast=False)
            rel_close(got, want, TOL, f"psi {psi}")


def test_edits_match_jax():
    rng = np.random.RandomState(5)
    ws = rng.randn(2, 12, 16).astype(np.float32)
    pca = {"comp": rng.randn(3, 16).astype(np.float32), "mean": np.zeros(16, np.float32)}
    dirs = [(0, 0, 4, 2.0), (2, 3, 12, -1.5), (0, 8, 9, 0.5)]
    rel_close(le.apply_ganspace_edit(torch.from_numpy(ws), pca, dirs),
              jle.apply_ganspace_edit(jnp.asarray(ws), pca, dirs), TOL, "ganspace")
    d = rng.randn(16).astype(np.float32)
    rel_close(le.apply_interfacegan(torch.from_numpy(ws), torch.from_numpy(d), -1.5),
              jle.apply_interfacegan(jnp.asarray(ws), jnp.asarray(d), -1.5), TOL, "interfacegan")
    for g, w in zip(le.interfacegan_factor_range(torch.from_numpy(ws), torch.from_numpy(d), (-2, 3)),
                    jle.interfacegan_factor_range(jnp.asarray(ws), jnp.asarray(d), (-2, 3))):
        rel_close(g, w, TOL, "range")
    assert le.STYLECLIP_EDITS == jle.STYLECLIP_EDITS
    for name in le.STYLECLIP_EDITS:
        a, b = le.levels_mapper_for_edit(name), jle.levels_mapper_for_edit(name)
        assert (a.use_coarse, a.use_medium, a.use_fine) == (b.use_coarse, b.use_medium, b.use_fine)


@pytest.mark.parametrize("flags", [(True, True, True), (True, False, True), (False, True, False)])
def test_levels_mapper_edit_matches_jax(flags):
    jm = jle.LevelsMapper(w_dim=32, num_ws=12, use_coarse=flags[0], use_medium=flags[1],
                          use_fine=flags[2])
    p = _np(jm.init(jax.random.PRNGKey(6)))
    m = le.LevelsMapper(32, 12, *flags)
    load_jax_params(m, {k: v for k, v in p.items() if hasattr(m, k)})
    ws = np.random.RandomState(7).randn(2, 12, 32).astype(np.float32)
    with torch.no_grad():
        rel_close(m.edit(torch.from_numpy(ws), 0.3), jm.edit(p, jnp.asarray(ws), 0.3), TOL, "edit")


def _styleclip_sd(w_dim=32, groups=("course", "medium", "fine"), prefix="mapper."):
    g = torch.Generator().manual_seed(0)
    sd = {}
    for group in groups:
        for i in range(1, 5):
            sd[f"{prefix}{group}_mapping.mapping.{i}.weight"] = torch.randn(w_dim, w_dim, generator=g) / 0.01
            sd[f"{prefix}{group}_mapping.mapping.{i}.bias"] = torch.randn(w_dim, generator=g)
    return sd


@pytest.mark.parametrize("groups", [("course", "medium", "fine"), ("course", "medium")])
def test_import_levels_mapper_matches_jax(groups, tmp_path):
    """A StyleCLIP checkpoint's state dict (keys under "mapper."; hair edits
    ship without the fine mapper) through both importers; also read from a
    torch.save'd {"state_dict", "opts"} file by styleclip_edit.load_mapper."""
    sd = _styleclip_sd(groups=groups)
    m = le.import_levels_mapper(sd, num_ws=12)
    jm, jp = jle.import_levels_mapper({k: v.numpy() for k, v in sd.items()}, num_ws=12)
    jm = jle.LevelsMapper(w_dim=32, num_ws=12, use_coarse=jm.use_coarse, use_medium=jm.use_medium,
                          use_fine=jm.use_fine)
    assert (m.use_coarse, m.use_medium, m.use_fine) == (jm.use_coarse, jm.use_medium, jm.use_fine)
    ws = np.random.RandomState(8).randn(2, 12, 32).astype(np.float32)
    with torch.no_grad():
        got = m.edit(torch.from_numpy(ws))
        rel_close(got, jm.edit(jp, jnp.asarray(ws)), TOL, "import")
        path = str(tmp_path / "afro.pt")
        torch.save({"state_dict": sd, "opts": {"description": "afro"}}, path)
        G = type("G", (), {"num_ws": 12, "w_dim": 32})()
        assert torch.equal(styleclip_edit.load_mapper(path, G).edit(torch.from_numpy(ws)), got)


# ------------------------------------------------------------------- StyleCLIP


def _tokens():
    return jclip.SimpleTokenizer(merges=MERGES).tokenize(["low"], context_length=12)


def test_mapper_step_matches_jax(bridged, clip_pair, arcface):
    """One coach step with the CLIP, ID and latent terms, on the JAX package's
    latents and mapper init: the stats and the updated mapper against the
    JAX step (the parameters within 1e-4 of the mapper's largest), and the
    mapper's gradients, tensor by tensor, against the JAX step's own gradient
    of its loss (train/styleclip.py:84-108), read from Adam's first moment
    after the first step (mu = (1 - b1) g). At the random inits the gradients
    are 1e-9..1e-6, as small as Adam's eps (1e-8), where the first update
    lr g / (|g| + eps) turns fp32 rounding of g into update differences of up
    to ~1e-3 lr: the biases, which start at 0, are held through their
    gradients."""
    jG, params, G = bridged
    jm, cp, m = clip_pair
    jarc, arc_tree, arc = arcface
    cfg = jstyleclip.StyleClipConfig(lr=0.05, batch_size=2)
    jmapper = jle.LevelsMapper(w_dim=512, num_ws=jG.num_ws)
    state = jstyleclip.init_styleclip_state(jmapper, jax.random.PRNGKey(2), cfg)
    p0 = _np(state.mapper_params)
    mapper = le.LevelsMapper(512, G.num_ws)
    load_jax_params(mapper, p0)
    w = np.asarray(jstyleclip.sample_latents(jG, params, 2, jax.random.PRNGKey(3), cfg.truncation_psi))
    tokens = jnp.asarray(_tokens())
    embed = lambda img: jarc.embed_faces(arc_tree, img)  # noqa: E731

    jstep = jstyleclip.make_styleclip_step(jG, params, jmapper, jm, cp, tokens, cfg, embed_id=embed)
    state, jstats = jstep(state, jnp.asarray(w))
    assert int(state.opt[0].count) == 1  # optax.adam's moments after its first update
    jgrad = jax.tree_util.tree_map(lambda mu: mu / (1.0 - 0.9), state.opt[0].mu)

    tcfg = styleclip.StyleClipConfig(lr=0.05, batch_size=2)
    step = styleclip.make_styleclip_step(G, mapper, m, torch.from_numpy(_tokens()), tcfg,
                                         embed_id=arc.embed_faces)
    stats = step(torch.from_numpy(w))
    jgrad = _np(jgrad)
    for name, p in mapper.named_parameters():  # the step leaves its gradient in .grad
        group, fc, leaf = name.split(".")
        ref = jgrad[group][fc][leaf]
        rel_close(p.grad.numpy(), ref.T if ref.ndim == 2 else ref, STEP_TOL, f"grad {name}")
    assert set(stats) == set(jstats) == {"loss", "loss_clip", "loss_id", "loss_l2_latent"}
    for k in stats:
        rel_close(stats[k], jstats[k], STEP_TOL, k)
    want = _np(state.mapper_params)
    scale = max(float(np.abs(v).max()) for v in jax.tree_util.tree_leaves(want))
    for name, p in mapper.state_dict().items():
        group, fc, leaf = name.split(".")
        ref = want[group][fc][leaf]
        err = float(np.abs(p.numpy() - (ref.T if ref.ndim == 2 else ref)).max())
        assert err <= STEP_TOL * scale, (name, err, scale)
    assert all(p.grad is None for p in G.parameters())


def test_optimize_latent_matches_jax(bridged, clip_pair):
    """Three steps of the latent optimizer (the first at lr 0 on the ramp)
    against the JAX loop, and the loss's gradient in w at a moved latent
    against jax.grad of the JAX loop's loss (train/styleclip.py:140-145)
    within 1e-4 x max|grad|. The latent is held within 2e-4 x max|w|: Adam
    normalizes each element, so an element whose gradient is 1e-2 of the
    largest carries its share of the rounding (1e-4 of the largest) as a
    1e-2 relative difference into its update (1.04e-4 x max|w| read here)."""
    jG, params, G = bridged
    jm, cp, m = clip_pair
    w0 = np.asarray(jstyleclip.sample_latents(jG, params, 1, jax.random.PRNGKey(4)))
    tokens = _tokens()
    want = jstyleclip.optimize_latent(jG, params, jm, cp, jnp.asarray(tokens), jnp.asarray(w0),
                                      steps=3, lr=0.05, l2_lambda=1.0, log_every=0)
    got = styleclip.optimize_latent(G, m, torch.from_numpy(tokens), torch.from_numpy(w0), steps=3,
                                    lr=0.05, l2_lambda=1.0, log_every=0)
    rel_close(got, want, 2 * STEP_TOL, "w")
    assert float((got - torch.from_numpy(w0)).abs().max()) > 0

    w1 = (w0 + 0.05 * np.random.RandomState(13).randn(*w0.shape)).astype(np.float32)
    c = _front(1)

    def jloss(w):
        img = jG.synthesis(params["synthesis"], w, jnp.asarray(c))
        return (jnp.mean(jclip.clip_similarity_loss(jm, cp, img, jnp.asarray(tokens)))
                + jnp.sum((w - w0) ** 2))

    wt = torch.from_numpy(w1).requires_grad_(True)
    loss = (tclip.clip_similarity_loss(m, G.synthesis(wt, torch.from_numpy(c)),
                                       torch.from_numpy(tokens)).mean()
            + (wt - torch.from_numpy(w0)).square().sum())
    (g,) = torch.autograd.grad(loss, [wt])
    rel_close(g, jax.jit(jax.grad(jloss))(jnp.asarray(w1)), STEP_TOL, "grad w")
    assert [styleclip.lr_ramp(i, 40, 0.1) for i in (0, 1, 20, 39)] == pytest.approx(
        [0.0, 0.05, 0.1, 0.1 * (0.5 - 0.5 * np.cos(0.1 * np.pi))])


# ------------------------------------------------------------------------ NADA


class _ConstJaxG:
    """The JAX G whose synthesis renders noise_mode 'const' whatever it is asked."""

    def __init__(self, jG):
        self.mapping, self._synthesis = jG.mapping, jG.synthesis

    def synthesis(self, p, ws, c, noise_mode="const", rng=None):
        return self._synthesis(p, ws, c)


def _perturbed(params, rng):
    """G's params with its raw-RGB head and superres stack moved off (+0.1
    N(0, 1)), their noise buffers and strengths apart (the port leaves the
    buffers out of Adam; at strength 0 their gradient is 0 in both)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * rng.randn(*x.shape).astype(np.float32)
        if (path[1].key == "raw_rgb" or path[1].key.startswith("b"))
        and path[-1].key not in ("noise_const", "noise_strength") else x, params)


@pytest.fixture(scope="module")
def nada_case(bridged, clip_pair):
    """The NADA inputs: the text direction, z, the trained copy's start, the
    JAX image embedder and the cameras."""
    jG, params, _ = bridged
    jm, cp, _ = clip_pair
    rng = np.random.RandomState(9)
    tdir = rng.randn(16).astype(np.float32)
    z = rng.randn(2, 512).astype(np.float32)
    start = _np(_perturbed(params, rng))  # numpy: the JAX step donates its state
    jembed = jclip.make_image_embedder(jm, cp)
    return tdir, z, start, jembed, jnp.asarray(_front(2))


@pytest.mark.parametrize("freeze_geometry", [True, False])
def test_nada_step_matches_jax(bridged, clip_pair, nada_case, monkeypatch, freeze_geometry):
    """One NADA step against the JAX step: the loss within 1e-5, the trained
    parameters' gradients (as the step leaves them) tensor by tensor against
    the JAX step's own gradient of its loss (train/nada.py:72-82), Adam's
    first moment after the step (betas (0, 0.99): mu = g), within 1e-4 x
    max|grad|, the
    updated synthesis within 1e-4 of its largest parameter, and every other
    parameter of the trained copy bit-identical. With betas (0, 0.99) Adam's
    first update is lr g / (|g| + eps), about lr sign(g): where |g| is near
    eps (1e-8) fp32 rounding moves it by up to ~lr, so the update is held
    through the gradients."""
    jG, params, G = bridged
    _, _, m = clip_pair
    tdir, z, start, jembed, c = nada_case
    jcfg = jnada.NadaConfig(freeze_geometry=freeze_geometry)
    assert jcfg.betas[0] == 0.0  # so that Adam's first moment is the gradient
    st = jnada.init_nada_state(jG, params, jcfg)._replace(
        params_train=jax.tree_util.tree_map(jnp.asarray, start))
    jstep = jnada.make_nada_step(_ConstJaxG(jG), params, jembed, jnp.asarray(tdir), jcfg)
    st, jloss_val = jstep(st, jnp.asarray(z), c, jax.random.PRNGKey(0))
    assert int(st.opt[0].count) == 1
    jgrad = _np(st.opt[0].mu)

    orig = Ide3dSynthesisNetwork.forward
    monkeypatch.setattr(Ide3dSynthesisNetwork, "forward",
                        lambda self, ws, c, noise_mode="const", generator=None, **kw:
                        orig(self, ws, c, **kw))
    cfg = nada.NadaConfig(freeze_geometry=freeze_geometry)
    G_train = load_jax_params(nada.init_nada(G, cfg), start)
    before = {k: v.clone() for k, v in G_train.state_dict().items()}
    embed, gen = tclip.make_image_embedder(m), torch.Generator().manual_seed(0)
    trained = nada.nada_parameters(G_train, freeze_geometry)
    step = nada.make_nada_step(G_train, G, embed, torch.from_numpy(tdir), cfg)
    loss = step(torch.from_numpy(z), torch.from_numpy(_front(2)), gen)
    assert abs(float(loss) - float(jloss_val)) <= 1e-5, (float(loss), float(jloss_val))
    want_grad = Ide3dGenerator(G.cfg).synthesis
    load_jax_params(want_grad, jgrad)
    for name, p in trained:  # the step leaves its gradient in .grad
        rel_close(p.grad.numpy(), want_grad.state_dict()[name].numpy(), STEP_TOL, f"grad {name}")
    want = Ide3dGenerator(G.cfg)
    load_jax_params(want, _np(st.params_train))
    names = {n for n, _ in trained}
    scale = max(float(v.abs().max()) for v in want.synthesis.state_dict().values())
    for name, p in G_train.synthesis.state_dict().items():
        err = float((p - want.synthesis.state_dict()[name]).abs().max())
        assert err <= STEP_TOL * scale, (name, err, scale)
        if name not in names:
            assert torch.equal(p, before[f"synthesis.{name}"]), name
    moved = [n for n in names if not torch.equal(G_train.synthesis.state_dict()[n],
                                                 before[f"synthesis.{n}"])]
    assert moved and (freeze_geometry or any(n.startswith("vb") for n in moved))
    assert all(torch.equal(v, before[f"mapping.{k}"]) for k, v in G_train.mapping.state_dict().items())


def test_nada_shares_draws_between_its_renders(bridged, clip_pair):
    """At step 0 the copies are equal and both renders draw the same layer
    noise, depth jitter and importance samples: e_t - e_f is exactly 0 and the
    loss exactly 1. With independent draws (the generator not reset) it is
    not. Geometry stays out of the optimizer unless asked in."""
    _, _, G = bridged
    _, _, m = clip_pair
    G = Ide3dGenerator(G.cfg)
    load_jax_params(G, _np(_noise_on(bridged[1])))
    G.eval()
    embed = tclip.make_image_embedder(m)
    tdir = torch.randn(16, generator=torch.Generator().manual_seed(1))
    tdir = tdir / tdir.norm()
    z, c = torch.randn(2, 512, generator=torch.Generator().manual_seed(2)), torch.from_numpy(_front(2))
    G_train = nada.init_nada(G)
    gen = torch.Generator().manual_seed(3)
    assert float(nada.nada_loss(G_train, G, embed, tdir, z, c, gen).detach()) == 1.0
    with torch.no_grad():
        ws = G.mapping(z, c)
        e_t = embed(G_train.synthesis(ws, c, noise_mode="random", generator=gen))
        e_f = embed(G.synthesis(ws, c, noise_mode="random", generator=gen))
    assert float((e_t - e_f).abs().max()) > 0
    names = {n for n, _ in nada.nada_parameters(G_train)}
    assert names and not any(n.startswith(("vb", "renderer")) or n.endswith("noise_const")
                             for n in names)
    assert any(n.startswith("vb") for n, _ in nada.nada_parameters(G_train, False))
    assert {n for n, p in G_train.synthesis.named_parameters() if p.requires_grad} == names


def _noise_on(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, 0.3) if path[-1].key == "noise_strength" else x, params)


# ------------------------------------------------------------------------ CLIs


class _JittedSynthesis:
    """The JAX G with its synthesis under one jax.jit: the same function, one
    compile instead of the hundreds of per-op compiles of the JAX
    styleclip_edit CLI's eager G calls."""

    def __init__(self, jG):
        self._jG = jG
        self.synthesis = jax.jit(jG.synthesis)

    def __getattr__(self, name):
        return getattr(self._jG, name)


@pytest.fixture
def both_clis(bridged, monkeypatch):
    """Both packages' load_generator hand out the bridged G (the JAX one with
    a jitted synthesis); their save_image_grid capture the images: {"jax":
    {name: array}, "port": {...}}."""
    jG, params, G = bridged
    saved = {"jax": {}, "port": {}}
    monkeypatch.setattr(jcommon, "load_generator", lambda network: (_JittedSynthesis(jG), params))
    monkeypatch.setattr(tcommon, "load_generator", lambda network, device="cuda": G.to(device))

    def capture(key):
        def save_image_grid(images, path, drange=(-1, 1), grid=None):
            saved[key]["/".join(path.split(os.sep)[-3:])] = (np.asarray(images, np.float32), grid)
        return save_image_grid

    monkeypatch.setattr(jcommon, "save_image_grid", capture("jax"))
    monkeypatch.setattr(tcommon, "save_image_grid", capture("port"))
    return saved


def _u8(x):
    return np.rint((np.asarray(x, np.float32) + 1) * 127.5).clip(0, 255)


def test_styleclip_edit_cli_matches_jax(both_clis, tmp_path):
    sd = _styleclip_sd(w_dim=512, groups=("course", "medium"))
    path = str(tmp_path / "afro.pt")
    torch.save({"state_dict": sd, "opts": {}}, path)
    lat = str(tmp_path / "face.npz")
    np.savez(lat, ws=np.random.RandomState(10).randn(1, 12, 512).astype(np.float32) * 0.3)
    from ide3d_tpu.apps import styleclip_edit as jstyleclip_edit

    argv = ["--network", "x", "--latents", lat, "--mapper", path, "--edit-name", "afro",
            "--yaws=-0.3,0.2", "--outdir", str(tmp_path / "out")]
    jstyleclip_edit.main(argv)
    styleclip_edit.main(argv + ["--device", "cpu"])
    key = "/".join(str(tmp_path / "out" / "afro.png").split(os.sep)[-3:])
    (got, ggrid), (want, wgrid) = both_clis["port"][key], both_clis["jax"][key]
    assert got.shape == want.shape == (4, 32, 32, 3) and ggrid == wgrid
    assert np.abs(_u8(got) - _u8(want)).max() <= 1


def _tiny_clip_files(tmp_path):
    """A random tiny CLIP (64-wide towers: one 64-dim head, as load_clip
    assumes) and a synthetic BPE vocab, as --clip and --bpe take them."""
    cfg = tclip.ClipConfig(embed_dim=16, image_resolution=32, vision_layers=1, vision_width=64,
                           vision_patch_size=8, context_length=12, vocab_size=520,
                           transformer_width=64, transformer_layers=1)
    clip_path, bpe = str(tmp_path / "clip.pt"), str(tmp_path / "bpe.txt.gz")
    torch.save(tclip.CLIP(cfg).init(0).state_dict(), clip_path)
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\nl o\nlo w</w>\n")
    return clip_path, bpe


@pytest.mark.parametrize("with_id", [False, True])
def test_train_styleclip_mapper_cli_and_its_edit(tmp_path, monkeypatch, with_id):
    """train_styleclip_mapper at random:0:tiny on the CPU (2 steps, finite
    stats), its mapper directory read back by styleclip_edit."""
    clip_path, bpe = _tiny_clip_files(tmp_path)
    argv = ["--network", "random:0:tiny", "--clip", clip_path, "--bpe", bpe, "--description",
            "low", "--steps", "2", "--outdir", str(tmp_path / "m"), "--device", "cpu",
            "--no-fine-mapper"]
    if with_id:
        arc = str(tmp_path / "arc.pth")
        torch.save(ArcFaceIRSE50().init().half().state_dict(), arc)
        argv += ["--ir-se50", arc]
    seen = []
    real = styleclip.make_styleclip_step

    def spy(G, mapper, clip_model, tokens, cfg, embed_id=None):
        step = real(G, mapper, clip_model, tokens, cfg, embed_id)
        return lambda w: seen.append(step(w)) or seen[-1]

    monkeypatch.setattr(styleclip, "make_styleclip_step", spy)
    mapper = train_styleclip_mapper.main(argv)
    assert len(seen) == 2 and all(torch.isfinite(v).all() for s in seen for v in s.values())
    assert ("loss_id" in seen[0]) == with_id and not mapper.use_fine
    np.savez(tmp_path / "w.npz", ws=np.zeros((1, 12, 512), np.float32))
    out = styleclip_edit.main(["--network", "random:0:tiny", "--latents", str(tmp_path / "w.npz"),
                               "--mapper", str(tmp_path / "m" / "mapper"), "--outdir",
                               str(tmp_path / "e"), "--device", "cpu"])
    with torch.no_grad():
        assert torch.equal(out["ws_edit"], mapper.cpu().edit(torch.zeros(1, 12, 512)))
    assert np.isfinite(out["frames"]).all() and os.path.exists(out["path"])


def test_train_nada_cli_adapts_appearance_alone(tmp_path):
    clip_path, bpe = _tiny_clip_files(tmp_path)
    out = train_nada.main(["--network", "random:0:tiny", "--clip", clip_path, "--bpe", bpe,
                           "--source", "low", "--target", "lo", "--steps", "2",
                           "--outdir", str(tmp_path / "n"), "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["losses"][0] == 1.0  # the copies start equal and share their draws
    G0 = tcommon.load_generator("random:0:tiny", "cpu")
    G1 = tcommon.load_generator(out["path"], "cpu")
    trained = {f"synthesis.{n}" for n, _ in nada.nada_parameters(G0)}
    s0, s1, st = G0.state_dict(), G1.state_dict(), out["G"].state_dict()
    assert all(torch.equal(s1[k], st[k]) for k in s1)  # the snapshot reloads
    assert all(torch.equal(s0[k], s1[k]) for k in s0 if k not in trained)
    assert any(not torch.equal(s0[k], s1[k]) for k in trained)


def _pti_dir(tmp_path, names):
    """A run_pti-layout directory (pivots and labels, no tuned snapshots) and
    the target images."""
    imgs, pti_dir = tmp_path / "imgs", tmp_path / "pti"
    imgs.mkdir()
    pti_dir.mkdir()
    rng = np.random.RandomState(11)
    for n in names:
        PIL.Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8)).save(imgs / f"{n}.png")
        np.savez(pti_dir / f"{n}.npz", ws=(rng.randn(1, 12, 512) * 0.3).astype(np.float32))
        np.savez(pti_dir / f"{n}_label.npz", c=_front(1))
    return str(imgs), str(pti_dir)


def test_edit_comparison_cli_matches_jax(both_clis, tmp_path):
    """The reconstruction and InterFaceGAN strips against the JAX CLI (its
    GANSpace basis draws its own z; the port's PCA is held in
    test_ganspace_pca_matches_jax_given_z)."""
    from ide3d_tpu.apps import edit_comparison as jedit_comparison

    imgs, pti_dir = _pti_dir(tmp_path, ["a", "b"])
    dirs = str(tmp_path / "dirs.npz")
    np.savez(dirs, smile=np.random.RandomState(12).randn(512).astype(np.float32) * 0.1)
    argv = ["--network", "x", "--images", imgs, "--pti", pti_dir, "--directions", dirs,
            "--interfacegan-max", "1.0", "--ganspace-components", "0"]
    jedit_comparison.main(argv + ["--outdir", str(tmp_path / "j")])
    edit_comparison.main(argv + ["--outdir", str(tmp_path / "t"), "--device", "cpu"])
    got, want = both_clis["port"], both_clis["jax"]
    assert sorted(got) == sorted(want) and len(got) == 2 * (1 + 2 * 5)
    for k in want:
        assert got[k][0].shape == want[k][0].shape, k
        assert np.abs(_u8(got[k][0]) - _u8(want[k][0])).max() <= 1, k


def test_experiment_runner_chains_the_legs(tmp_path):
    """run_pti, latent_creator and edit_comparison at random:0:tiny on the
    CPU, with the GANSpace ladder, through one command."""
    imgs, _ = _pti_dir(tmp_path, ["a"])
    rc = experiment_runner.main(["--network", "random:0:tiny", "--images", imgs, "--outdir",
                                 str(tmp_path / "exp"), "--projector-steps", "2", "--pti-steps",
                                 "2", "--create-other-latents", "--compare", "--device", "cpu"])
    assert rc == 0
    exp = tmp_path / "exp"
    assert (exp / "pti" / "a.npz").exists() and (exp / "pti" / "model_a").exists()
    assert (exp / "lat_sg2plus" / "a.npz").exists()
    strips = glob.glob(str(exp / "comparison" / "a" / "concat_images" / "*.jpg"))
    assert len(strips) == 1 + 2 * 9  # rec + 2 components x range(-20, 25, 5)
    strip = np.asarray(PIL.Image.open(exp / "comparison" / "a" / "concat_images" / "rec.jpg"))
    assert strip.shape == (32, 32 * 3, 3)  # target | SG2Plus | PTI


def test_editing_entry_points_reach_the_cpu_only_when_asked(monkeypatch, tmp_path):
    class _Stop(Exception):
        pass

    seen = []

    def fake_load(network, device="cuda"):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(tcommon, "load_generator", fake_load)
    runs = {
        styleclip_edit: ["--network", "x", "--latents", "l", "--mapper", "m", "--outdir", "o"],
        train_styleclip_mapper: ["--network", "x", "--clip", "c", "--bpe", "b",
                                 "--description", "d", "--outdir", "o"],
        train_nada: ["--network", "x", "--clip", "c", "--bpe", "b", "--source", "s",
                     "--target", "t", "--outdir", "o"],
        edit_comparison: ["--network", "x", "--images", "i", "--outdir", "o"],
    }
    for mod, argv in runs.items():
        for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            with pytest.raises(_Stop):
                mod.main(argv + extra)
            assert seen.pop() == torch.device(want), mod.__name__
    calls = []
    monkeypatch.setattr("ide3d_tpu_torch.apps.run_pti.main", lambda a: calls.append(a) or 0)
    experiment_runner.main(["--network", "x", "--images", "i", "--outdir", str(tmp_path)])
    assert calls[-1][-2:] == ["--device", "cuda"]
