"""The PyTorch port's ops against the JAX package's, on the CPU, in fp32.

Inputs are made with numpy from a seed; JAX runs NHWC/HWIO, the port NCHW/OIHW.
Tolerance: atol 1e-5 (fp32, the same algebra in another summation order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu_torch.ops import bias_act as tba
from ide3d_tpu_torch.ops import conv2d_gradfix
from ide3d_tpu_torch.ops import conv2d_resample as tcr
from ide3d_tpu_torch.ops import grid_sample as tgs
from ide3d_tpu_torch.ops import modulated_conv as tmc
from ide3d_tpu_torch.ops import upfirdn2d as tud
from torch_threads import one_intra_op_thread  # noqa: F401 (a fixture)

# ide3d_tpu.ops re-exports functions under its modules' names, so take the modules themselves.
jba, jcr, jgs, jmc, jud = (importlib.import_module(f"ide3d_tpu.ops.{m}") for m in (
    "bias_act", "conv2d_resample", "grid_sample", "modulated_conv", "upfirdn2d"))
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield



def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def close(got, ref, atol=ATOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=atol)


@pytest.mark.parametrize("act", sorted(jba.activation_funcs))
@pytest.mark.parametrize("clamp", [None, 0.5])
def test_bias_act(act, clamp):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 6).astype(np.float32) * 2
    b = rng.randn(6).astype(np.float32)
    ref = jba.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, clamp=clamp)
    got = tba.bias_act(nchw(x), torch.from_numpy(b), act=act, clamp=clamp)
    close(nhwc(got), ref)
    assert tba.activation_funcs[act].def_gain == jba.activation_funcs[act].def_gain
    assert tba.activation_funcs[act].def_alpha == jba.activation_funcs[act].def_alpha


@pytest.mark.parametrize("up,down,padding,flip,taps", [
    (1, 1, 0, False, (1, 3, 3, 1)),
    (2, 1, (2, 1), False, (1, 3, 3, 1)),
    (1, 2, (1, 1, 2, 0), True, (1, 3, 3, 1)),
    (2, 2, (-1, 2, 0, 1), False, (1, 2, 3, 4)),
    (3, 1, 1, True, tuple(range(1, 9))),  # 8 taps: separable
])
def test_upfirdn2d(up, down, padding, flip, taps):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, 6, 3).astype(np.float32)
    jf, tf = jud.setup_filter(taps), tud.setup_filter(taps)
    close(tf.numpy(), jf)
    ref = jud.upfirdn2d(jnp.asarray(x), jf, up=up, down=down, padding=padding, flip_filter=flip, gain=1.5)
    got = tud.upfirdn2d(nchw(x), tf, up=up, down=down, padding=padding, flip_filter=flip, gain=1.5)
    close(nhwc(got), ref)


@pytest.mark.parametrize("fn", ["upsample2d", "downsample2d", "filter2d"])
def test_resample_wrappers(fn):
    rng = np.random.RandomState(2)
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    ref = getattr(jud, fn)(jnp.asarray(x), jud.setup_filter((1, 3, 3, 1)))
    got = getattr(tud, fn)(nchw(x), tud.setup_filter((1, 3, 3, 1)))
    close(nhwc(got), ref)


@pytest.mark.parametrize("up,down,flip,k", [
    (1, 1, True, 3), (1, 1, False, 3), (2, 1, False, 3), (1, 2, True, 3), (2, 1, True, 1),
])
def test_conv2d_resample(up, down, flip, k):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.randn(k, k, 4, 5).astype(np.float32)
    f = (1, 3, 3, 1) if (up > 1 or down > 1) else None
    jf = None if f is None else jud.setup_filter(f)
    tf = None if f is None else tud.setup_filter(f)
    ref = jcr.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jf, up=up, down=down,
                              padding=k // 2, flip_weight=flip)
    got = tcr.conv2d_resample(nchw(x), oihw(w), f=tf, up=up, down=down, padding=k // 2,
                              flip_weight=flip)
    close(nhwc(got), ref)


@pytest.mark.parametrize("up,demod,k", [(1, True, 3), (2, True, 3), (1, False, 1), (2, False, 3)])
def test_modulated_conv2d(up, demod, k):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    w = rng.randn(k, k, 6, 5).astype(np.float32)
    s = rng.randn(2, 6).astype(np.float32) + 1.0
    noise = rng.randn(1, 8 * up, 8 * up, 1).astype(np.float32)
    jf = jud.setup_filter((1, 3, 3, 1)) if up > 1 else None
    tf = tud.setup_filter((1, 3, 3, 1)) if up > 1 else None
    ref = jmc.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), noise=jnp.asarray(noise),
                               up=up, padding=k // 2, resample_filter=jf, demodulate=demod,
                               flip_weight=(up == 1))
    got = tmc.modulated_conv2d(nchw(x), oihw(w), torch.from_numpy(s), noise=nchw(noise), up=up,
                               padding=k // 2, resample_filter=tf, demodulate=demod,
                               flip_weight=(up == 1))
    close(nhwc(got), ref)


def test_triplane_sum_matches_jax():
    """Points inside, on the border of, and outside the [-1,1] cube (zeros padding)."""
    rng = np.random.RandomState(5)
    planes = rng.randn(2, 9, 7, 3 * 5).astype(np.float32)
    coords = (rng.rand(2, 300, 3).astype(np.float32) * 2.6 - 1.3)
    ref = jgs.sample_from_triplane(jnp.asarray(coords), jnp.asarray(planes))
    got = tgs.sample_from_triplane(torch.from_numpy(coords), torch.from_numpy(planes))
    close(got.numpy(), ref)


def test_triplane_keeps_dtype_and_samples_in_fp32():
    rng = np.random.RandomState(6)
    planes = torch.from_numpy(rng.randn(1, 16, 16, 3 * 4).astype(np.float32)).bfloat16()
    coords = torch.from_numpy(rng.rand(1, 50, 3).astype(np.float32) * 2 - 1)
    got = tgs.sample_from_triplane(coords, planes)
    ref = tgs.sample_from_triplane(coords, planes.float())
    assert got.dtype == torch.bfloat16
    close(got.float().numpy(), ref.bfloat16().float().numpy(), atol=0)


@pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 0, 1), (1, (2, 1), 4), (2, 1, 4)])
def test_conv2d_gradfix_matches_conv2d_to_second_order(stride, padding, groups, one_intra_op_thread):
    """Forward, first and second derivatives of conv2d_gradfix.conv2d equal
    F.conv2d's (float64): the R1 shape, a gradient of a squared input
    gradient, taken in the weights. At stride 2 the even height needs an
    output padding of 1 in the input gradient, the odd width one of 0."""
    g = torch.Generator().manual_seed(stride + groups)
    x = torch.randn(1, 4, 6, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 4 // groups, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)

    def r1(conv):
        y = conv(x, w, stride=stride, padding=padding, groups=groups)
        (gx,) = torch.autograd.grad((y.tanh() * y).sum(), x, create_graph=True)
        return gx, torch.autograd.grad(gx.square().sum(), w)[0]

    for got, ref in zip(r1(conv2d_gradfix.conv2d), r1(torch.nn.functional.conv2d)):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-10, atol=1e-10)
    assert torch.autograd.gradgradcheck(
        lambda x, w: conv2d_gradfix.conv2d(x, w, stride=stride, padding=padding, groups=groups), (x, w))
    with conv2d_gradfix.no_weight_gradients():
        gx, gw = torch.autograd.grad(conv2d_gradfix.conv2d(x, w, stride, padding, groups).sum(), (x, w),
                                     allow_unused=True)
    assert gx is not None and gw is None
