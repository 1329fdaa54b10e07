"""The PyTorch port's ADA against the JAX package, on the CPU, fp32.

The draws cannot match (torch.Generator against jax.random), so the
application is held to JAX at given matrices (`_apply_warp`, `_apply_color`,
the cutout mask at given centres and gates), and the draws to their contracts:
the identity at p = 0, one Bernoulli for both translation axes, pre- and
post-rotation each at p_rot. The p controller is host arithmetic and must
match exactly. Inputs are made with numpy from a seed.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu.train import augment as jaug
from ide3d_tpu_torch.ops import grid_sample
from ide3d_tpu_torch.train import augment as taug
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

F32 = dict(compute_dtype="float32")


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, atol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=atol)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _jax_matrix_draws(p, B, W, H, key):
    keys = jax.random.split(key, 16)
    cfg = jaug.AugmentConfig()
    return jaug._geometry_matrix(keys, p, cfg, B, W, H), jaug._color_matrix(keys, p, cfg, B)


def _jax_matrices(p, B, W, H, seed=0):
    """JAX's geometry and colour matrices (one compiled program of the draws,
    not one compile per op)."""
    return tuple(np.asarray(m) for m in _jax_matrix_draws(p, B, W, H, jax.random.PRNGKey(seed)))


_jax_warp = jax.jit(jaug._apply_warp)


def test_warp_matches_jax_at_given_matrices():
    B, H, W = 4, 16, 12
    Gm, _ = _jax_matrices(0.8, B, W, H)
    img = np.random.RandomState(0).randn(B, H, W, 5).astype(np.float32)
    ref = _jax_warp(jnp.asarray(img), jnp.asarray(Gm))
    close(taug._apply_warp(t(img), t(Gm)).numpy(), ref)


def test_color_matches_jax_at_given_matrices():
    B = 4
    _, Cm = _jax_matrices(0.8, B, 8, 8, seed=1)
    img = np.random.RandomState(1).randn(B, 8, 8, 3).astype(np.float32)
    close(taug._apply_color(t(img), t(Cm)).numpy(), jaug._apply_color(jnp.asarray(img), jnp.asarray(Cm)))


def test_cutout_mask_matches_jax_at_given_draws():
    """JAX's _cutout_mask draws its gate from `key` and its centres from
    fold_in(key, 1); the same draws given to the port's mask."""
    B, H, W, p = 8, 10, 14, 0.7
    cfg = jaug.AugmentConfig(cutout=1.0, cutout_size=0.4)
    key = jax.random.PRNGKey(3)
    ref = jaug._cutout_mask(key, p, cfg, B, H, W)
    gate = np.asarray(jax.random.uniform(key, (B,)) < cfg.cutout * p, np.float32)
    center = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1), (B, 2)))
    got = taug._cutout_mask_at(t(center), t(gate), cfg.cutout_size, H, W)
    close(got.numpy(), ref, atol=0)
    assert 0 < float(got.mean()) < 1


def test_apply_augment_matches_jax_composition():
    """One warp on img, raw and seg; colour on the two RGB stacks; the mask on all."""
    B, R = 4, 16
    Gm, Cm = _jax_matrices(0.6, B, R, R, seed=2)
    rng = np.random.RandomState(2)
    img, raw = (rng.randn(B, R, R, 3).astype(np.float32) for _ in range(2))
    seg = rng.randn(B, R, R, 19).astype(np.float32)
    mask = (rng.rand(B, R, R) > 0.3).astype(np.float32)
    stack = _jax_warp(jnp.concatenate([img, raw, seg], -1), jnp.asarray(Gm))
    ref = (jaug._apply_color(stack[..., :3], jnp.asarray(Cm)) * mask[..., None],
           jaug._apply_color(stack[..., 3:6], jnp.asarray(Cm)) * mask[..., None],
           stack[..., 6:] * mask[..., None])
    got = taug.apply_augment(t(img), t(raw), t(seg), t(Gm), t(Cm), t(mask),
                             taug.AugmentConfig(**F32))
    for g, r in zip(got, ref):
        close(g.numpy(), r)


def test_augment_d_input_at_p0_is_the_identity():
    B, R = 3, 16
    rng = np.random.RandomState(4)
    img, raw, seg = (t(rng.randn(B, R, R, c).astype(np.float32)) for c in (3, 3, 19))
    cfg = taug.AugmentConfig(cutout=1.0, **F32)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(taug._geometry_matrix(gen, 0.0, cfg, B, R, R), torch.eye(3).expand(B, 3, 3))
    assert torch.equal(taug._color_matrix(gen, 0.0, cfg, B), torch.eye(4).expand(B, 4, 4))
    out = taug.augment_d_input(gen, img, raw, seg, 0.0, cfg)
    for o, i in zip(out, (img, raw, seg)):
        close(o.numpy(), i.numpy(), atol=1e-5)


def _only(**on):
    names = ("xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac")
    return taug.AugmentConfig(**{n: on.get(n, 0.0) for n in names})


@pytest.mark.parametrize("kind", ["xint", "xfrac"])
def test_one_bernoulli_gates_both_translation_axes(kind):
    B, p = 4096, 0.5
    Gm = taug._geometry_matrix(torch.Generator().manual_seed(1), p, _only(**{kind: 1.0}), B, 4096, 4096)
    tx, ty = Gm[:, 0, 2], Gm[:, 1, 2]
    moved_x, moved_y = tx != 0, ty != 0
    assert float((moved_x != moved_y).float().mean()) < 0.01  # xint: a shift may round to 0 on one axis
    assert abs(float(moved_x.float().mean()) - p) < 0.05
    assert torch.equal(Gm[:, :2, :2], torch.eye(2).expand(B, 2, 2))


def test_pre_and_post_rotation_each_fire_at_p_rot():
    """P(any rotation) = rotate * p, from two independent rotations at
    p_rot = 1 - sqrt(1 - rotate * p) each."""
    B, p = 8192, 0.5
    Gm = taug._geometry_matrix(torch.Generator().manual_seed(2), p, _only(rotate=1.0), B, 64, 64)
    rotated = (Gm[:, 0, 1].abs() > 0).float().mean()
    assert abs(float(rotated) - p) < 0.03
    assert abs(1.0 - math.sqrt(1.0 - p) - 0.2929) < 1e-4
    # pre- and post-rotation compose into one rotation: still orthonormal
    R2 = Gm[:, :2, :2]
    close((R2 @ R2.transpose(1, 2)).numpy(), torch.eye(2).expand(B, 2, 2).numpy(), atol=1e-5)


def test_draws_follow_the_generator():
    B, R = 2, 8
    img, raw, seg = (torch.randn(B, R, R, c, generator=torch.Generator().manual_seed(c))
                     for c in (3, 3, 19))
    cfg = taug.AugmentConfig(cutout=0.5, **F32)
    a = taug.augment_d_input(torch.Generator().manual_seed(5), img, raw, seg, 0.9, cfg)
    b = taug.augment_d_input(torch.Generator().manual_seed(5), img, raw, seg, 0.9, cfg)
    c = taug.augment_d_input(torch.Generator().manual_seed(6), img, raw, seg, 0.9, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.allclose(a[0], c[0])
    assert a[0].dtype == torch.float32
    bf = taug.augment_d_input(torch.Generator().manual_seed(5), img, raw, seg, 0.9, taug.AugmentConfig())
    assert all(x.dtype == torch.bfloat16 for x in bf)


def test_warp_differentiates_twice():
    """The warp and its transpose are each other's gradients, so R1's double
    backward goes through (float64 gradgradcheck on a grid reaching past the
    border); and the first gradient equals grid_sample's own."""
    x = torch.randn(2, 2, 5, 4, dtype=torch.float64, requires_grad=True)
    grid = torch.rand(2, 3, 5, 2, generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64) * 2.4 - 1.2
    assert torch.autograd.gradgradcheck(lambda x: grid_sample._Sample.apply(x, grid, False), (x,))
    g = torch.randn(2, 2, 3, 5, dtype=torch.float64)
    ref = torch.autograd.grad(torch.nn.functional.grid_sample(x, grid, align_corners=False), x, g)[0]
    close(torch.autograd.grad(grid_sample._Sample.apply(x, grid, False), x, g)[0].numpy(), ref.numpy(),
          atol=1e-12)


def test_ada_controller_matches_jax():
    """The same sign sequence through both controllers, update every 4 batches."""
    rng = np.random.RandomState(0)
    signs = rng.uniform(-1, 1, 40) + 0.5
    js, ts = jaug.ada_init(), taug.ada_init()
    for i, s in enumerate(signs):
        js, ts = jaug.ada_accumulate(js, s, 8), taug.ada_accumulate(ts, s, 8)
        if i % 4 == 3:
            js = jaug.ada_update(js, 32, target=0.6, speed_kimg=0.5, p_max=0.3)
            ts = taug.ada_update(ts, 32, target=0.6, speed_kimg=0.5, p_max=0.3)
            assert ts.p == js.p and ts.rt_accum == js.rt_accum
    assert 0 < ts.p <= 0.3
