"""The PyTorch port's GAN training against the JAX package, on the CPU, fp32.

The tiny preset of tests/test_train.py (32² out, 16² planes, 8² render, 4+4
samples), initialised by JAX and bridged through io/from_jax.py, with non-zero
layer-noise strengths so that the const noise takes part. The draws cannot
match (torch.Generator against jax.random), so the losses and gradients are
held to a JAX loss built from the JAX package's public Ide3dGenerator,
Discriminator and augment helpers at fixed z, with const noise and the
deterministic render, and ADA at given matrices; R1 against jax.grad of
jax.grad. The step itself, checkpoints and the train_gan CLI are in
tests/test_torch_train_step.py.

Also the two repairs of the training slice: the plain K1's gradient in the
values against jax.grad of integrate_rays_merged, and the render's importance
depths without a gradient. The CUDA backward is held to the plain one by
tests/test_torch_cuda.py (marker `cuda`) and chip_smoke.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ide3d_tpu import render as jrender
from ide3d_tpu.models import Discriminator as JDiscriminator
from ide3d_tpu.models import DiscriminatorConfig as JDiscriminatorConfig
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.render import camera as jcam
from ide3d_tpu.render import integration as jint
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.render.renderer import TriplaneRenderer as JRenderer
from ide3d_tpu.train import augment as jaug
from ide3d_tpu.train.gan import expand_compact_batch as j_expand
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.ops import ray_march
from ide3d_tpu_torch.render.renderer import RenderParams, TriplaneRenderer
from ide3d_tpu_torch.train import augment as taug
from ide3d_tpu_torch.train import gan
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
TINY_D = dict(img_resolution=32, img_channels=25, channel_base=512, channel_max=32,
              dtype="float32")
B, R = 4, 32  # B a multiple of the stddev group: the D phase's interleaved call
TCFG = gan.GanTrainConfig(aug=taug.AugmentConfig(compute_dtype="float32"))
# fp32 losses and gradients, only the order of sums differs; the gradients of G
# pass through the render's sorts, grid sampling and the composite.
TOL = 2e-4


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, tol=TOL, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (name, float(np.abs(got - ref).max()), scale)


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


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(3)
    cams = [np.asarray(jrender.make_label_25(jrender.look_at_pose(
        np.pi / 2 + 0.3 * (i - 1.5), np.pi / 2, [0.0, 0.0, 0.0], radius=2.7)))[0] for i in range(B)]
    return {"z": rng.randn(B, 512).astype(np.float32),
            "c": np.stack(cams).astype(np.float32),
            "img": rng.uniform(-1, 1, (B, R, R, 3)).astype(np.float32),
            "seg": (np.eye(19, dtype=np.float32)[rng.randint(0, 19, (B, R, R))] * 2 - 1),
            "fake": [rng.randn(B, R, R, n).astype(np.float32) * 0.5 for n in (3, 3, 19)]}


def _grads_in_port_layout(module_cls, cfg, tree):
    """A JAX gradient tree in the port's layouts, by name."""
    m = module_cls(cfg)
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, tree))
    return m.state_dict()


def _compare_grads(named_params, grads, ref, tol=TOL):
    n = 0
    for (name, _), g in zip(named_params, grads):
        if g is None:  # unused by the loss: JAX's gradient is zero
            assert float(ref[name].abs().max()) == 0, name
            continue
        close(g.numpy(), ref[name].numpy(), tol, name)
        n += 1
    return n


def _jax_real_triple(img, seg, rs):
    raw = jax.image.resize(img, (img.shape[0], rs, rs, 3), "bilinear")
    return img, jax.image.resize(raw, img.shape, "bilinear"), seg


# ------------------------------------------------------------- the two repairs

@pytest.mark.parametrize("opts", [
    dict(), dict(clamp_mode="relu"), dict(last_back=True), dict(white_back=True),
    dict(noise=True), dict(clamp_mode="relu", last_back=True, white_back=True, noise=True),
])
def test_plain_k1_gradient_matches_jax_integrate_rays_merged(opts):
    """d/d(values) of a loss on K1's three outputs against jax.grad of the
    JAX fine composite, unsorted halves with ties. Densities keep every alpha
    below 1 - 1e-10: integrate_rays_merged floors log(1 - alpha) at log(1e-10)
    and K1 does not, so their gradients differ behind a saturated sample."""
    opts = dict(opts)
    rng = np.random.RandomState(9)
    b, r, sa, sb, C = 2, 24, 7, 9, 6
    za, zb = (np.round((rng.rand(b, r, s, 1) * 1.05 + 2.25) * 8).astype(np.float32) / 8
              for s in (sa, sb))
    va = rng.randn(b, r, sa, C + 1).astype(np.float32) * 3
    vb = rng.randn(b, r, sb, C + 1).astype(np.float32) * 3
    d = rng.randn(b, r, 3).astype(np.float32)
    noise = rng.randn(b, r, sa + sb).astype(np.float32) * 0.5 if opts.pop("noise", False) else None
    gf, gd, gw = (rng.randn(b, r, n).astype(np.float32) for n in (C, 1, 1))
    z = jnp.asarray(np.concatenate([za, zb], 2))

    def jloss(fs):
        if noise is not None:
            fs = fs.at[..., -1].add(noise)
        comp, depth, w = jint.integrate_rays_merged(fs, jnp.asarray(d), z, **opts)
        return jnp.sum(comp * gf) + jnp.sum(depth * gd) + jnp.sum(w.sum(-2) * gw)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(np.concatenate([va, vb], 2))))
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    got = ray_march.sort_integrate_backward(
        t(za), t(va), t(zb), t(vb), t(norm), t(gf), t(gd), t(gw),
        noise=None if noise is None else t(noise), **opts)
    close(torch.cat(got, dim=2).numpy(), ref, tol=3e-5)
    assert ray_march.sort_integrate_backward.launches == 0  # the CPU runs the plain version


@pytest.fixture(scope="module")
def renderer_pair():
    jr = JRenderer(feature_channels=8, seg_channels=5)
    params = jr.init(jax.random.PRNGKey(1))
    tr = TriplaneRenderer(feature_channels=8, seg_channels=5)
    load_jax_params(tr, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(5)
    planes = (rng.randn(2, 16, 16, 24).astype(np.float32), rng.randn(2, 16, 16, 15).astype(np.float32))
    c2w = np.array(jcam.look_at_pose(1.7, 1.5, [0.0, 0.0, 0.0], radius=2.7, batch_size=2))
    c2w[1] = np.asarray(jcam.look_at_pose(1.3, 1.6, [0.0, 0.0, 0.0], radius=2.7))[0]
    return jr, params, tr, planes, c2w


def test_importance_depths_carry_no_gradient(renderer_pair):
    """render_coarse detaches fine_z, as the JAX render stop-gradients it."""
    _, _, tr, (img_v, seg_v), c2w = renderer_pair
    st = tr.render_coarse(t(img_v).requires_grad_(), t(seg_v).requires_grad_(), t(c2w),
                          RenderParams(img_size=8, num_steps=10))
    assert st["coarse"].grad_fn is not None
    assert st["fine_z"].grad_fn is None and not st["fine_z"].requires_grad


@pytest.mark.parametrize("opts", [dict(), dict(white_back=True, last_back=True)])
def test_fine_render_gradient_matches_jax(renderer_pair, opts):
    """d/d(planes, decoder) of a loss on every render output, deterministic
    render, against jax.grad of the JAX render."""
    jr, params, tr, (img_v, seg_v), c2w = renderer_pair
    w = [np.random.RandomState(i).randn(2, 8, 8, n).astype(np.float32) for i, n in enumerate((8, 5, 1, 1))]
    keys = ("feature", "seg", "depth", "weights_sum")
    jrp = JRenderParams(img_size=8, num_steps=10, **opts)

    def jloss(p, iv, sv):
        out = jr.render(p, iv, sv, jnp.asarray(c2w), jrp)
        return sum(jnp.sum(out[k] * wk) for k, wk in zip(keys, w))

    ref_p, ref_i, ref_s = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.asarray(img_v), jnp.asarray(seg_v))
    iv, sv = t(img_v).requires_grad_(), t(seg_v).requires_grad_()
    tr.zero_grad()
    out = tr.render(iv, sv, t(c2w), RenderParams(img_size=8, num_steps=10, **opts))
    sum((out[k] * t(wk)).sum() for k, wk in zip(keys, w)).backward()
    close(iv.grad.numpy(), ref_i, 1e-4)
    close(sv.grad.numpy(), ref_s, 1e-4)
    ref = _grads_in_port_layout(lambda _: TriplaneRenderer(8, 5), None, ref_p)
    for name, p in tr.named_parameters():
        close(p.grad.numpy(), ref[name].numpy(), 1e-4, name)


# ----------------------------------------------------- losses against JAX

def _d_in_plain(triple):
    return gan.d_input(triple, TCFG, None, 0.0)


def test_g_loss_and_gradients_match_jax(bridged, inputs):
    jG, gp, G, jD, dp, D = bridged
    z, c = inputs["z"], inputs["c"]

    def jloss(p):
        ws = jG.mapping(p["mapping"], jnp.asarray(z), jnp.asarray(c))
        out = jG.synthesis(p["synthesis"], ws, jnp.asarray(c), noise_mode="const", return_all=True)
        raw_up = jax.image.resize(out["img_raw"], (B, R, R, 3), "bilinear")
        logits = jD(dp, jnp.concatenate([out["img"], raw_up, out["seg"]], -1), jnp.asarray(c))
        return jnp.mean(jax.nn.softplus(-logits))

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(gp)
    loss, stats, fakes = gan.g_loss(G, D, t(z), t(c), TCFG, None, _d_in_plain)
    close(loss.detach().numpy(), ref_loss)
    assert all(f.grad_fn is None for f in fakes) and stats["loss_g"].grad_fn is None
    named = list(G.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    ref = _grads_in_port_layout(Ide3dGenerator, G.cfg, ref_g)
    assert _compare_grads(named, grads, ref) > 50


@pytest.mark.parametrize("batch", [B, 2])
def test_d_loss_and_gradients_match_jax(bridged, inputs, batch):
    """B = 4: one interleaved D call; B = 2: two calls (not a multiple of the group)."""
    _, _, G, jD, dp, D = bridged
    c, img, seg = inputs["c"][:batch], inputs["img"][:batch], inputs["seg"][:batch]
    fake = [f[:batch] for f in inputs["fake"]]

    def jloss(p):
        real = _jax_real_triple(jnp.asarray(img), jnp.asarray(seg), 8)
        if batch % 4 == 0:
            both = [jnp.stack([jnp.asarray(f), r], 1).reshape((-1,) + f.shape[1:])
                    for f, r in zip(fake, real)]
            logits = jD(p, jnp.concatenate(both, -1), jnp.repeat(jnp.asarray(c), 2, axis=0))
            lf, lr = logits[0::2], logits[1::2]
        else:
            lf = jD(p, jnp.concatenate([jnp.asarray(f) for f in fake], -1), jnp.asarray(c))
            lr = jD(p, jnp.concatenate(real, -1), jnp.asarray(c))
        return jnp.mean(jax.nn.softplus(lf)) + jnp.mean(jax.nn.softplus(-lr))

    ref_loss, ref_g = jax.jit(jax.value_and_grad(jloss))(dp)
    real = gan.d_triple_real(t(img), t(seg), G.cfg.render_size)
    loss, stats = gan.d_loss(D, tuple(t(f) for f in fake), real, t(c), _d_in_plain)
    close(loss.detach().numpy(), ref_loss)
    named = list(D.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert _compare_grads(named, grads, _grads_in_port_layout(Discriminator, D.cfg, ref_g)) == len(named)
    assert -1 <= float(stats["real_signs"]) <= 1


def test_r1_through_ada_matches_jax_grad_of_grad(bridged, inputs):
    """R1 = E||d D(aug(x)) / d x||² over the pre-augmentation real triple, ADA
    at given matrices, and its gradient in D's parameters (jax.grad of jax.grad)."""
    _, _, G, jD, dp, D = bridged
    c, img, seg = inputs["c"], inputs["img"], inputs["seg"]
    keys = jax.random.split(jax.random.PRNGKey(4), 16)
    Gm = jaug._geometry_matrix(keys, 0.8, jaug.AugmentConfig(), B, R, R)
    Cm = jaug._color_matrix(keys, 0.8, jaug.AugmentConfig(), B)

    def jr1(p):
        def d_sum(x, raw, s):
            stack = jaug._apply_warp(jnp.concatenate([x, raw, s], -1), Gm)
            d_in = jnp.concatenate([jaug._apply_color(stack[..., :3], Cm),
                                    jaug._apply_color(stack[..., 3:6], Cm), stack[..., 6:]], -1)
            return jnp.sum(jD(p, d_in, jnp.asarray(c)))

        grads = jax.grad(d_sum, argnums=(0, 1, 2))(*_jax_real_triple(jnp.asarray(img), jnp.asarray(seg), 8))
        return sum(jnp.sum(jnp.square(g)) for g in grads) / B

    ref_r1, ref_g = jax.jit(jax.value_and_grad(jr1))(dp)
    Gt, Ct = t(np.asarray(Gm)), t(np.asarray(Cm))

    def d_in(triple):
        return torch.cat(taug.apply_augment(*triple, Gt, Ct, None, TCFG.aug), dim=-1)

    real = gan.d_triple_real(t(img), t(seg), G.cfg.render_size)
    r1 = gan.r1_penalty(D, real, t(c), d_in)
    close(r1.detach().numpy(), ref_r1)
    named = list(D.named_parameters())
    grads = torch.autograd.grad(r1, [p for _, p in named], allow_unused=True)
    assert _compare_grads(named, grads, _grads_in_port_layout(Discriminator, D.cfg, ref_g)) > 20


def test_expand_compact_batch_matches_jax():
    rng = np.random.RandomState(7)
    compact = {"img": rng.randint(0, 256, (2, 8, 8, 3), np.uint8),
               "seg": rng.randint(0, 19, (2, 8, 8), np.uint8), "c": rng.randn(2, 25).astype(np.float32)}
    ref = j_expand({k: jnp.asarray(v) for k, v in compact.items()})
    got = gan.expand_compact_batch({k: t(v) for k, v in compact.items()})
    for k in compact:
        close(got[k].numpy(), ref[k], 1e-7, k)
    again = gan.expand_compact_batch(got)  # the step's format passes through
    assert all(again[k] is got[k] for k in got)


def test_adam_step_matches_optax():
    """torch.optim.Adam(betas=(0, 0.99), eps=1e-8) as init_gan_state builds it
    against optax.adam, three steps."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(3)]
    opt = optax.adam(0.002, b1=0.0, b2=0.99)
    jw, js = jnp.asarray(w0), opt.init(jnp.asarray(w0))
    p = torch.nn.Parameter(t(w0))
    topt = torch.optim.Adam([p], lr=0.002, betas=(0.0, 0.99), eps=1e-8)
    for g in grads:
        upd, js = opt.update(jnp.asarray(g), js, jw)
        jw = optax.apply_updates(jw, upd)
        p.grad = t(g)
        topt.step()
        close(p.detach().numpy(), jw, 1e-6)


def test_pose_swap():
    c = t(np.arange(4 * 25, dtype=np.float32).reshape(4, 25))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(gan.pose_swap(c, gen, 0.0), c)
    assert torch.equal(gan.pose_swap(c, gen, 1.0), torch.roll(c, 1, dims=0))
    assert gan.pose_swap(None, gen, 1.0) is None
    part, rolled = gan.pose_swap(c, gen, 0.5), torch.roll(c, 1, dims=0)
    assert all(torch.equal(part[i], c[i]) or torch.equal(part[i], rolled[i]) for i in range(4))
