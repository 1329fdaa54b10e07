"""The last features of the JAX trainer in the PyTorch port, on the CPU, fp32:
K1's double backward, path-length regularization, the twice-differentiable
samplers, the wavelet ADA warp, a JAX training snapshot resumed by the port's
train_gan, and the port's synthetic dataset tool.

Each is held to the JAX package on the same inputs, made with numpy from a
seed: the plain double backward (`sort_integrate_double_backward_plain`)
against jax.vjp of jax.vjp of `integrate_rays_merged`; the PL penalty and its
G gradients against the JAX expression of `pl_penalty_fn` on bridged tiny
weights at given ws and y, with const noise and the deterministic render (the
draws cannot match); the wavelet warp and R1 through it at given matrices.
The CUDA kernel of the double backward is held to the plain version by
chip_smoke.py (phase 14); here its autograd wiring runs with the forward
routed to the plain version.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ide3d_tpu import render as jrender
from ide3d_tpu.models import Discriminator as JDiscriminator
from ide3d_tpu.models import DiscriminatorConfig as JDiscriminatorConfig
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.render import integration as jint
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.train import augment as jaug
from ide3d_tpu.train import gan as jgan
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.ops import grid_sample, ray_march
from ide3d_tpu_torch.render.renderer import RenderParams
from ide3d_tpu_torch.train import augment as taug
from ide3d_tpu_torch.train import gan
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
TINY_D = dict(img_resolution=32, img_channels=25, channel_base=512, channel_max=32,
              dtype="float32")
B, R = 4, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, tol, name=""):
    """max |got - ref| <= tol * max(1, max |ref|), after a finiteness check."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (name, float(np.abs(got - ref).max()), scale)


def _graph_names(x) -> set:
    """The class names of every autograd node behind x."""
    names, stack = set(), [x.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and type(fn).__name__ not in names:
            names.add(type(fn).__name__)
            stack.extend(f for f, _ in fn.next_functions)
    return names


# ------------------------------------------------------------- K1's double backward

K1_OPTS = [dict(), dict(clamp_mode="relu"), dict(last_back=True), dict(white_back=True),
           dict(noise=True), dict(clamp_mode="relu", last_back=True, white_back=True, noise=True)]


def _k1_case(opts, seed=9):
    """Inputs of the first-order test in tests/test_torch_train.py (unsorted
    halves with ties, densities that keep every alpha below 1 - 1e-10), the
    backward's cotangents and the double backward's gg."""
    opts = dict(opts)
    rng = np.random.RandomState(seed)
    b, r, sa, sb, C = 2, 24, 7, 9, 6
    za, zb = (np.round((rng.rand(b, r, s, 1) * 1.05 + 2.25) * 8).astype(np.float32) / 8
              for s in (sa, sb))
    va = rng.randn(b, r, sa, C + 1).astype(np.float32) * 3
    vb = rng.randn(b, r, sb, C + 1).astype(np.float32) * 3
    d = rng.randn(b, r, 3).astype(np.float32)
    noise = rng.randn(b, r, sa + sb).astype(np.float32) * 0.5 if opts.pop("noise", False) else None
    cot = [rng.randn(b, r, n).astype(np.float32) for n in (C, 1, 1)]
    gg = [rng.randn(*v.shape).astype(np.float32) for v in (va, vb)]
    return opts, za, zb, va, vb, d, noise, cot, gg


@pytest.mark.parametrize("opts", K1_OPTS)
def test_plain_double_backward_matches_jax_second_derivative(opts):
    """The gradient of <gg, K1's backward> in the values and the three
    cotangents against jax.vjp of jax.vjp of the JAX fine composite. fp32, the
    order of sums differs: <= 1e-5 x max(1, max |ref|)."""
    opts, za, zb, va, vb, d, noise, (gf, gd, gw), (gga, ggb) = _k1_case(opts)
    z = jnp.asarray(np.concatenate([za, zb], 2))

    def outputs(fs):
        if noise is not None:
            fs = fs.at[..., -1].add(noise)
        comp, depth, w = jint.integrate_rays_merged(fs, jnp.asarray(d), z, **opts)
        return comp, depth.reshape(gd.shape), w.sum(-2)

    def backward(fs, gf, gd, gw):
        return jax.vjp(outputs, fs)[1]((gf, gd, gw))[0]

    @jax.jit
    def second(fs, gf, gd, gw, gg):
        return jax.vjp(backward, fs, gf, gd, gw)[1](gg)

    ref = [np.asarray(x) for x in second(np.concatenate([va, vb], 2), gf, gd, gw,
                                         np.concatenate([gga, ggb], 2))]
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    got = ray_march.sort_integrate_double_backward(
        t(za), t(va), t(zb), t(vb), t(norm), t(gf), t(gd), t(gw), t(gga), t(ggb),
        noise=None if noise is None else t(noise), **opts)
    close(torch.cat(got[:2], dim=2).numpy(), ref[0], 1e-5, "vals")
    for name, g, r in zip(("g_feat", "g_depth", "g_wsum"), got[2:], ref[1:]):
        close(g.numpy(), r, 1e-5, name)
    assert ray_march.sort_integrate_double_backward.launches == 0  # the CPU runs the plain version


def test_double_backward_wiring_differentiates_k1_twice_and_no_more(monkeypatch):
    """The autograd wiring of the card's path (`_SortIntegrateFn` ->
    `_SortIntegrateBackwardFn` -> the double backward), with K1's forward
    routed to the plain version: a create_graph gradient differentiated
    again equals autograd through the plain K1, and a third derivative raises."""
    opts, za, zb, va, vb, d, noise, _, _ = _k1_case(dict(last_back=True, white_back=True), 3)
    norm = t(np.linalg.norm(d, axis=-1, keepdims=True))
    monkeypatch.setattr(ray_march, "_launch_forward",
                        lambda *a: ray_march.sort_integrate_plain(*a[:5], *a[5:]))
    w = [t(np.random.RandomState(i).randn(*s).astype(np.float32))
         for i, s in enumerate(((2, 24, 6), (2, 24, 1), (2, 24, 1)))]

    def second(fn):
        a, b = t(va).requires_grad_(), t(vb).requires_grad_()
        outs = fn(t(za), a, t(zb), b, norm)
        g = torch.autograd.grad(sum((o * wi).sum() for o, wi in zip(outs, w)), (a, b),
                                create_graph=True)
        m = sum((x.square() * x.detach().sign()).sum() for x in g)
        return torch.autograd.grad(m, (a, b), create_graph=True), (a, b), g

    def wired(*args):
        return ray_march._SortIntegrateFn.apply(*args, None, "softplus", True, True)

    got, leaves, first = second(wired)
    ref, _, _ = second(lambda *a: ray_march.sort_integrate_plain(*a, last_back=True,
                                                                  white_back=True))
    assert "_SortIntegrateBackwardFnBackward" in _graph_names(first[0])
    for g, r in zip(got, ref):
        close(g.detach().numpy(), r.detach().numpy(), 1e-6)
    with pytest.raises(RuntimeError, match="twice"):
        sum(g.sum() for g in got).backward()
    assert all(x.grad is None for x in leaves)


# ------------------------------------------------------- path-length regularization

def _set_noise_strength(params, v=0.3):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, v) if path[-1].key == "noise_strength" else x, params)


@pytest.fixture(scope="module")
def bridged():
    """(JAX G, its params, port G; JAX D, its params, port D), same weights."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    gp = _set_noise_strength(jax.jit(jG.init)(jax.random.PRNGKey(0)))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, gp))
    jD = JDiscriminator(JDiscriminatorConfig(**TINY_D))
    dp = jax.jit(jD.init)(jax.random.PRNGKey(1))
    D = Discriminator(DiscriminatorConfig(**TINY_D))
    load_jax_params(D, jax.tree_util.tree_map(np.asarray, dp))
    return jG, gp, G, jD, dp, D


def _cams(n):
    return np.stack([np.asarray(jrender.make_label_25(jrender.look_at_pose(
        np.pi / 2 + 0.3 * (i - 1.5), np.pi / 2, [0.0, 0.0, 0.0], radius=2.7)))[0]
        for i in range(n)]).astype(np.float32)


def test_pl_penalty_and_gradients_match_jax(bridged):
    """The penalty, mean(lengths) and the penalty's G gradients against
    pl_penalty_fn's expression at given ws, y and pl_mean (tolerance as
    tests/test_torch_train.py's g-loss: 2e-4 x max(1, max |ref|))."""
    jG, gp, G, _, _, _ = bridged
    rng = np.random.RandomState(4)
    ws = rng.randn(2, G.num_ws, 512).astype(np.float32) * 0.5
    c = _cams(2)
    y = rng.randn(2, R, R, 3).astype(np.float32) / R
    pl_mean = 0.7

    def jpl(p):
        def synth(ws_in):
            img = jG.synthesis(p["synthesis"], ws_in, jnp.asarray(c), noise_mode="const")
            return jnp.sum(img * y)

        grads = jax.grad(synth)(jnp.asarray(ws))
        lengths = jnp.sqrt(jnp.mean(jnp.sum(jnp.square(grads), axis=2), axis=1))
        return jnp.mean(jnp.square(lengths - pl_mean)), lengths.mean()

    (ref_pen, ref_len), ref_g = jax.jit(jax.value_and_grad(jpl, has_aux=True))(gp)
    pen, lengths = gan.pl_penalty(G, t(ws).requires_grad_(), t(c), torch.tensor(pl_mean), None,
                                  y=t(y))
    close(pen.detach().numpy(), ref_pen, 2e-4, "penalty")
    close(lengths.detach().mean().numpy(), ref_len, 2e-4, "mean length")
    named = list(G.named_parameters())
    grads = torch.autograd.grad(pen, [p for _, p in named], allow_unused=True)
    ref = load_jax_params(Ide3dGenerator(G.cfg), jax.tree_util.tree_map(np.asarray, ref_g))
    ref = ref.state_dict()
    n = 0
    for (name, _), g in zip(named, grads):
        if g is None:
            assert float(ref[name].abs().max()) == 0, name
            continue
        close(g.numpy(), ref[name].numpy(), 2e-4, name)
        n += 1
    assert n > 50


def _tiny_state(tcfg, seed=0):
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    D = Discriminator(DiscriminatorConfig(**TINY_D))
    return gan.init_gan_state(G.init(seed), D.init(seed + 1), tcfg)


def _compact_batch(b, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": t(rng.randint(0, 256, (b, R, R, 3), np.uint8)),
            "seg": t(rng.randint(0, 19, (b, R, R), np.uint8)), "c": t(_cams(b))}


def test_pl_runs_on_its_interval_and_pl_mean_follows_the_decay(monkeypatch):
    """pl_weight 2: PL on steps 0 and 4 of 5, pl_penalty 0 on the others,
    pl_mean += PL_DECAY * (mean(lengths) - pl_mean) on the PL steps only; the
    PL gradient moves G beyond the plain step's. PL_INTERVAL and PL_DECAY are
    the JAX config's defaults."""
    jcfg = jgan.GanTrainConfig()
    assert (gan.PL_INTERVAL, gan.PL_DECAY) == (jcfg.pl_interval, jcfg.pl_decay)
    seen = []
    real = gan.pl_penalty

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(float(out[1].detach().mean()))
        return out

    monkeypatch.setattr(gan, "pl_penalty", spy)
    tcfg = gan.GanTrainConfig(pl_weight=2.0, r1_interval=100, use_ada=False)
    state = _tiny_state(tcfg)
    step = gan.make_gan_train_step(tcfg)
    gen = torch.Generator().manual_seed(0)
    pen, means, expect = [], [], 0.0
    for i in range(5):
        state, stats = step(state, _compact_batch(B, i), gen)
        assert all(torch.isfinite(v) for v in stats.values())
        pen.append(float(stats["pl_penalty"]))
        means.append(float(state.pl_mean))
        if i % gan.PL_INTERVAL == 0:
            expect = expect + gan.PL_DECAY * (seen[-1] - expect)
        assert means[-1] == pytest.approx(expect, rel=1e-6)
    assert len(seen) == 2
    assert pen[0] > 0 and pen[4] > 0 and pen[1] == pen[2] == pen[3] == 0
    assert means[0] == means[3] != means[4]


# --------------------------------------------------------- twice-differentiable samplers

@pytest.mark.parametrize("dims", [2, 3])
def test_sample_bilinear_matches_grid_sample_and_differentiates_twice(dims):
    """Values and input gradients equal F.grid_sample's; the double backward
    against float64 finite differences (gradgradcheck), on a grid reaching
    past the border, for both align_corners."""
    gen = torch.Generator().manual_seed(dims)
    shape = (2, 2, 5, 4) if dims == 2 else (2, 2, 3, 4, 5)
    gshape = (2, 3, 5, 2) if dims == 2 else (2, 1, 3, 5, 3)
    x = torch.randn(*shape, dtype=torch.float64, generator=gen, requires_grad=True)
    grid = torch.rand(*gshape, generator=gen, dtype=torch.float64) * 2.4 - 1.2
    for ac in (False, True):
        y = grid_sample.sample_bilinear(x, grid, ac)
        ref = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=ac)
        assert type(y.grad_fn).__name__.startswith("_Sample")
        close(y.detach().numpy(), ref.detach().numpy(), 1e-12)
        g = torch.randn(ref.shape, dtype=torch.float64, generator=gen)
        close(torch.autograd.grad(y, x, g)[0].numpy(), torch.autograd.grad(ref, x, g)[0].numpy(),
              1e-12)
        assert torch.autograd.gradgradcheck(lambda v: grid_sample.sample_bilinear(v, grid, ac), (x,))


def test_coordinate_gradients_stay_on_grid_sample():
    """A grid that carries a gradient (a caller optimizing the pose) takes
    F.grid_sample, and its coordinate gradient is F.grid_sample's; the
    tri-plane lookup of a fixed point set takes the twice-differentiable path."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 6, 6, generator=gen, requires_grad=True)
    grid = (torch.rand(1, 4, 4, 2, generator=gen) * 2 - 1).requires_grad_()
    y = grid_sample.sample_bilinear(x, grid, False)
    assert type(y.grad_fn).__name__ == "GridSampler2DBackward0"
    ref = F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    close(torch.autograd.grad(y.sum(), grid)[0].numpy(), torch.autograd.grad(ref.sum(), grid)[0].numpy(),
          1e-6)
    planes = torch.randn(1, 4, 4, 6, generator=gen, requires_grad=True)
    coords = torch.rand(1, 5, 3, generator=gen) * 2 - 1
    (g,) = torch.autograd.grad(grid_sample.sample_from_triplane(coords, planes).square().sum(),
                               planes, create_graph=True)
    assert "_SampleTBackward" in _graph_names(g)
    assert torch.autograd.grad(g.sum(), planes)[0].abs().sum() > 0


def test_warp_moved_to_the_sampler_module():
    """ADA's warp runs through ops.grid_sample (one sampler for the warp, the
    tri-plane and the volume lookups)."""
    x = torch.randn(2, 8, 8, 3, requires_grad=True)
    y = taug._apply_warp(x, torch.eye(3)[None].repeat(2, 1, 1) * torch.tensor([1.0, -1, 1])[:, None])
    assert "_SampleBackward" in _graph_names(y)


# ------------------------------------------------------------------ wavelet ADA

def _matrices(seed=4):
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    return np.asarray(jaug._geometry_matrix(keys, 0.8, jaug.AugmentConfig(), B, R, R))


@pytest.mark.parametrize("channels", [3, 25])
def test_wavelet_warp_matches_jax(channels):
    """_apply_warp with wavelet_aa against JAX's at given matrices (random
    draws at p 0.8, the identity, an integer translation), 32² images: fp32,
    the order of sums differs: <= 2e-5 x max(1, max |ref|); the identity and
    the integer translation also reproduce the input (as the JAX tests
    `test_wavelet_warp_identity_is_exact`, `..._integer_translate_is_exact`).
    WAVELET_MARGIN is the JAX config's default."""
    assert taug.WAVELET_MARGIN == jaug.AugmentConfig().wavelet_margin
    rng = np.random.RandomState(channels)
    x = rng.randn(B, R, R, channels).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    shift = np.asarray(jaug._translate2d(jnp.asarray([4.0 / R]), jnp.asarray([0.0])))[0]
    tcfg = taug.AugmentConfig(wavelet_aa=True)
    jwarp = jax.jit(lambda x, G: jaug._apply_warp(x, G, jaug.AugmentConfig(wavelet_aa=True)))
    for name, G in (("draws", _matrices()), ("identity", np.stack([eye] * B)),
                    ("translate", np.stack([shift] * B))):
        ref = np.asarray(jwarp(x, G))
        got = taug._apply_warp(t(x), t(G), tcfg).numpy()
        close(got, ref, 2e-5, name)
    close(taug._apply_warp(t(x), t(np.stack([eye] * B)), tcfg).numpy(), x, 1e-4, "identity")
    close(taug._apply_warp(t(x), t(np.stack([shift] * B)), tcfg).numpy()[:, :, 4:], x[:, :, 2:-2],
          1e-4, "translate")


def test_r1_through_wavelet_ada_matches_jax_grad_of_grad(bridged):
    """R1 = E||d D(aug(x)) / d x||² through the wavelet warp and the colour
    matrix at given draws, and its D gradients, against jax.grad of jax.grad
    (tolerance as the bilinear warp's test: 2e-4 x max(1, max |ref|))."""
    _, _, G, jD, dp, D = bridged
    rng = np.random.RandomState(3)
    c = _cams(B)
    img = rng.uniform(-1, 1, (B, R, R, 3)).astype(np.float32)
    seg = np.eye(19, dtype=np.float32)[rng.randint(0, 19, (B, R, R))] * 2 - 1
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    Gm = jaug._geometry_matrix(keys, 0.8, jaug.AugmentConfig(), B, R, R)
    Cm = jaug._color_matrix(keys, 0.8, jaug.AugmentConfig(), B)
    jcfg = jaug.AugmentConfig(wavelet_aa=True)

    def real_triple(x, s):
        raw = jax.image.resize(x, (B, 8, 8, 3), "bilinear")
        return x, jax.image.resize(raw, x.shape, "bilinear"), s

    def jr1(p):
        def d_sum(x, raw, s):
            stack = jaug._apply_warp(jnp.concatenate([x, raw, s], -1), Gm, jcfg)
            d_in = jnp.concatenate([jaug._apply_color(stack[..., :3], Cm),
                                    jaug._apply_color(stack[..., 3:6], Cm), stack[..., 6:]], -1)
            return jnp.sum(jD(p, d_in, jnp.asarray(c)))

        grads = jax.grad(d_sum, argnums=(0, 1, 2))(*real_triple(jnp.asarray(img), jnp.asarray(seg)))
        return sum(jnp.sum(jnp.square(g)) for g in grads) / B

    ref_r1, ref_g = jax.jit(jax.value_and_grad(jr1))(dp)
    acfg = taug.AugmentConfig(wavelet_aa=True, compute_dtype="float32")
    Gt, Ct = t(np.asarray(Gm)), t(np.asarray(Cm))

    def d_in(triple):
        return torch.cat(taug.apply_augment(*triple, Gt, Ct, None, acfg), dim=-1)

    real = gan.d_triple_real(t(img), t(seg), G.cfg.render_size)
    r1 = gan.r1_penalty(D, real, t(c), d_in)
    close(r1.detach().numpy(), ref_r1, 2e-4, "r1")
    named = list(D.named_parameters())
    grads = torch.autograd.grad(r1, [p for _, p in named], allow_unused=True)
    ref = Discriminator(D.cfg)
    load_jax_params(ref, jax.tree_util.tree_map(np.asarray, ref_g))
    ref = ref.state_dict()
    n = 0
    for (name, _), g in zip(named, grads):
        if g is not None:
            close(g.numpy(), ref[name].numpy(), 2e-4, name)
            n += 1
    assert n > 20


# ----------------------------------------------------- a JAX run resumed in the port

def _write_dataset(root, n=2):
    import PIL.Image

    imgs, segs = root / "imgs", root / "segs"
    imgs.mkdir()
    segs.mkdir()
    rng = np.random.RandomState(0)
    labels = {}
    for i in range(n):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(imgs / name)
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(segs / name)
        labels[name] = np.asarray(jrender.CANONICAL_POSE_25, float).tolist()
    with open(imgs / "dataset.json", "w") as f:
        json.dump({"labels": list(labels.items())}, f)
    return ["--data", str(imgs), "--seg", str(segs)]


def test_jax_training_snapshot_resumes_in_the_port(tmp_path):
    """A JAX training state of the CLI's tiny layout after 4 Adam updates (on
    random gradients), saved by the JAX package's save_checkpoint and
    converted by tools/jax_ckpt_to_torch.py: every parameter, Adam moment and
    count, pl_mean and ada_p equal the JAX tree's. Then the port's train_gan
    --resume takes its step 4 with --pl-weight 2 (a PL step) and --wavelet-aa."""
    import sys

    from ide3d_tpu.io.checkpoint import save_checkpoint as jax_save
    from ide3d_tpu_torch.apps.train_gan import main
    from ide3d_tpu_torch.io.checkpoint import load_checkpoint

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import jax_ckpt_to_torch

    jcfg = JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4))
    tcfg = jgan.GanTrainConfig()
    jD = JDiscriminator(JDiscriminatorConfig(img_resolution=R, img_channels=25))
    rng = np.random.default_rng(1)

    def noise_like(tree):
        return jax.tree_util.tree_map(
            lambda x: np.asarray(rng.standard_normal(x.shape, dtype=np.float32)), tree)

    # The state's structure from the JAX init, with random parameters (an
    # init would compile the G and the CLI's 512-channel D for nothing).
    st = jax.eval_shape(lambda k: jgan.init_gan_state(k, JGenerator(jcfg), jD, tcfg),
                        jax.random.PRNGKey(0))
    st = st._replace(params_g=noise_like(st.params_g), params_d=noise_like(st.params_d))
    opt_g, opt_d = jgan.make_optimizers(tcfg)
    upd_g, upd_d = (jax.jit(lambda g, s, p, o=o: o.update(g, s, p)[1]) for o in (opt_g, opt_d))
    og, od = (jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), jax.eval_shape(o.init, p))
              for o, p in ((opt_g, st.params_g), (opt_d, st.params_d)))  # optax's init: zeros
    grads_g, grads_d = noise_like(st.params_g), noise_like(st.params_d)
    for k in range(4):  # gradients of another scale each step
        og = upd_g(jax.tree_util.tree_map(lambda g: g * (k + 1), grads_g), og, st.params_g)
        od = upd_d(jax.tree_util.tree_map(lambda g: g * (-1.0) ** k, grads_d), od, st.params_d)
    ema = noise_like(st.params_g)
    tree = {"G": st.params_g, "D": st.params_d, "G_ema": ema, "opt_g": og, "opt_d": od,
            "pl_mean": jnp.asarray(0.37, jnp.float32)}
    jax_save(str(tmp_path / "jax"), tree, config=jcfg, step=4, ada_p=0.25)
    jax_ckpt_to_torch.convert(str(tmp_path / "jax"), str(tmp_path / "port"))

    saved, meta = load_checkpoint(str(tmp_path / "port"))
    assert meta["step"] == 4 and meta["ada_p"] == 0.25
    assert float(saved["pl_mean"]) == np.float32(0.37)
    cfg = GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4))
    dcfg = DiscriminatorConfig(img_resolution=R, img_channels=25)
    for key, make, jtree in (("G", lambda: Ide3dGenerator(cfg), st.params_g),
                             ("G_ema", lambda: Ide3dGenerator(cfg), ema),
                             ("D", lambda: Discriminator(dcfg), st.params_d)):
        ref = load_jax_params(make(), jax.tree_util.tree_map(np.asarray, jtree)).state_dict()
        assert set(saved[key]) == set(ref)
        assert all(torch.equal(saved[key][k], ref[k]) for k in ref), key
    for key, make, jstate in (("opt_g", lambda: Ide3dGenerator(cfg), og),
                              ("opt_d", lambda: Discriminator(dcfg), od)):
        (adam,) = [s for s in jstate if hasattr(s, "mu")]
        mu, nu = (list(load_jax_params(make(), jax.tree_util.tree_map(np.asarray, x)).parameters())
                  for x in (adam.mu, adam.nu))
        state = saved[key]["state"]
        assert len(state) == len(mu) and int(adam.count) == 4
        for i in range(len(mu)):
            assert float(state[i]["step"]) == 4.0
            assert torch.equal(state[i]["exp_avg"], mu[i].detach()), (key, i)
            assert torch.equal(state[i]["exp_avg_sq"], nu[i].detach()), (key, i)
        assert saved[key]["param_groups"][0]["betas"] == (0.0, 0.99)

    resumed = main(_write_dataset(tmp_path) + [
        "--batch", "2", "--kimg", "0.01", "--resolution", str(R), "--preset", "tiny",
        "--grid-kimg", "1", "--snap-kimg", "1", "--device", "cpu", "--pl-weight", "2",
        "--wavelet-aa", "--outdir", str(tmp_path / "run"), "--resume", str(tmp_path / "port")])
    assert resumed.step == 5
    assert float(resumed.pl_mean) != pytest.approx(0.37)  # step 4 took the PL term
    meta = json.loads((tmp_path / "run" / "snapshot-final" / "meta.json").read_text())
    assert meta["step"] == 5 and meta["ada_p"] == pytest.approx(0.25, abs=1e-3)
    assert float(resumed.opt_g.state_dict()["state"][0]["step"]) == 5.0
    for name in ("jax", "port", "run"):  # ~0.9 GB of snapshots (the CLI's 512-channel D)
        shutil.rmtree(tmp_path / name)


# --------------------------------------------------------- the synthetic dataset tool

def test_synthetic_dataset_tool_matches_jax(tmp_path):
    """tools/torch_make_synthetic_dataset.py against tools/make_synthetic_dataset.py
    at 2 identities x 2 views, 32²: the same file names, images and masks
    bit for bit, labels within fp32 rounding of the camera math (1e-6)."""
    import sys

    import PIL.Image

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_synthetic_dataset
    import torch_make_synthetic_dataset

    args = ["--identities", "2", "--views", "2", "--resolution", "32", "--seed", "3"]
    make_synthetic_dataset.main(args + ["--out", str(tmp_path / "jax")])
    torch_make_synthetic_dataset.main(args + ["--out", str(tmp_path / "port")])
    for sub in ("img", "seg"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and len(names) >= 4
        for n in names:
            if n.endswith(".png"):
                a = np.asarray(PIL.Image.open(tmp_path / "jax" / sub / n))
                b = np.asarray(PIL.Image.open(tmp_path / "port" / sub / n))
                assert np.array_equal(a, b), (sub, n)
    lj = json.loads((tmp_path / "jax" / "img" / "dataset.json").read_text())["labels"]
    lt = json.loads((tmp_path / "port" / "img" / "dataset.json").read_text())["labels"]
    assert [n for n, _ in lj] == [n for n, _ in lt]
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lj], atol=1e-6, rtol=0)
