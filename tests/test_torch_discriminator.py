"""The PyTorch port's discriminator against the JAX package, on the CPU, fp32.

A tiny D (32² input, 25 channels, 32 channels a block) is initialised by JAX
and bridged through io/from_jax.py; inputs are made with numpy from a seed.
Tolerances: logits and gradients within 1e-5 x max(1, scale) (fp32, only the
order of sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu.models.discriminator import Discriminator as JDiscriminator
from ide3d_tpu.models.discriminator import DiscriminatorConfig as JDiscriminatorConfig
from ide3d_tpu.models.discriminator import minibatch_stddev as j_minibatch_stddev
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.discriminator import (Discriminator, DiscriminatorConfig,
                                                  minibatch_stddev)
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

TINY_D = dict(img_resolution=32, img_channels=25, channel_base=512, channel_max=32,
              dtype="float32")


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, tol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale


def bridge(cfg: dict, seed: int = 0):
    jD = JDiscriminator(JDiscriminatorConfig(**cfg))
    params = jax.jit(jD.init)(jax.random.PRNGKey(seed))
    D = Discriminator(DiscriminatorConfig(**cfg))
    load_jax_params(D, jax.tree_util.tree_map(np.asarray, params))
    return jD, params, D


@pytest.fixture(scope="module")
def bridged():
    return bridge(TINY_D)


def _inputs(B, seed=1, channels=25):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, 32, 32, channels).astype(np.float32) * 0.5
    c = rng.randn(B, 25).astype(np.float32)
    return img, c


def test_state_dict_names_follow_the_jax_tree(bridged):
    _, params, D = bridged
    leaves = {".".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    assert set(D.state_dict()) == leaves
    assert "b4.out.weight" in leaves and "mapping.fc7.weight" in leaves
    assert "b32.fromrgb.weight" in leaves and "b16.fromrgb.weight" not in leaves


@pytest.mark.parametrize("B", [4, 8])
def test_forward_matches_jax(bridged, B):
    jD, params, D = bridged
    img, c = _inputs(B)
    ref = jax.jit(jD.__call__)(params, jnp.asarray(img), jnp.asarray(c))
    with torch.no_grad():
        got = D(t(img), t(c))
    close(got.numpy(), ref)


@pytest.mark.parametrize("N,group", [(8, 4), (4, 4), (2, 4), (6, 4), (8, 2), (3, None)])
def test_minibatch_stddev_matches_jax(N, group):
    """Strided groups (sample s in group s mod n), NCHW here, NHWC there."""
    x = np.random.RandomState(N).randn(N, 4, 4, 6).astype(np.float32)
    ref = np.asarray(j_minibatch_stddev(jnp.asarray(x), group, 2))
    got = minibatch_stddev(t(x).permute(0, 3, 1, 2), group, 2).permute(0, 2, 3, 1)
    close(got.numpy(), ref)


def test_parameter_and_input_gradients_match_jax(bridged):
    """d/d(params, input) of sum(logits * w), the gradients the D loss and R1 take."""
    jD, params, D = bridged
    img, c = _inputs(4, seed=2)
    w = np.random.RandomState(3).randn(4, 1).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jD(p, x, jnp.asarray(c)) * w)

    ref_p, ref_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, jnp.asarray(img))
    x = t(img).requires_grad_()
    D.zero_grad()
    (D(x, t(c)) * t(w)).sum().backward()
    close(x.grad.numpy(), ref_x)
    conv = Discriminator(DiscriminatorConfig(**TINY_D))  # the JAX gradients in the port's layouts
    load_jax_params(conv, jax.tree_util.tree_map(np.asarray, ref_p))
    ref = conv.state_dict()
    for name, p in D.named_parameters():
        close(p.grad.numpy(), ref[name].numpy())


def test_batched_d_matches_two_calls():
    """One D call over interleaved fake/real rows gives the logits of two
    separate calls at B % group_size == 0 (strided stddev groups stay
    single-half); a plain concat mixes the groups and does not."""
    _, _, D = bridge(dict(TINY_D, img_channels=6))
    B = 8
    rng = np.random.RandomState(7)
    fake = t(rng.randn(B, 32, 32, 6).astype(np.float32) * 0.3)
    real = t(rng.randn(B, 32, 32, 6).astype(np.float32) * 0.3)
    c = t(rng.randn(B, 25).astype(np.float32))
    with torch.no_grad():
        lf, lr = D(fake, c), D(real, c)
        both = torch.stack([fake, real], dim=1).reshape((-1,) + fake.shape[1:])
        logits = D(both, c.repeat_interleave(2, dim=0))
        close(logits[0::2].numpy(), lf.numpy())
        close(logits[1::2].numpy(), lr.numpy())
        cat = D(torch.cat([fake, real]), torch.cat([c, c]))
    assert float((cat[:B] - lf).abs().max()) > 1e-6


def test_bf16_discriminator_matches_jax_bf16():
    """The bf16 D (blocks in bf16, epilogue fp32) against the JAX bf16 D: the
    two round at other places, so within 3e-2 x scale."""
    cfg = dict(TINY_D, dtype="bfloat16")
    jD, params, D = bridge(cfg, seed=4)
    img, c = _inputs(4, seed=5)
    ref = jax.jit(jD.__call__)(params, jnp.asarray(img), jnp.asarray(c))
    with torch.no_grad():
        got = D(t(img), t(c))
    assert got.dtype == torch.float32
    close(got.numpy(), ref, tol=3e-2)


def test_init_is_seeded():
    a = Discriminator(DiscriminatorConfig(**TINY_D)).init(3).state_dict()
    b = Discriminator(DiscriminatorConfig(**TINY_D)).init(3).state_dict()
    c = Discriminator(DiscriminatorConfig(**TINY_D)).init(4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["b32.conv0.weight"], c["b32.conv0.weight"])
    assert torch.equal(a["b32.conv0.bias"], torch.zeros(16))
