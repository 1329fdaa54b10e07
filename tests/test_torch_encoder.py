"""The port's Conv2dLayer, encoders and seg one-hot against the JAX package, on the CPU.

Weights are drawn by the JAX `init` and bridged through io/from_jax.py; the same
seeded numpy inputs go through both sides (NHWC on both: the port permutes).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu.models import encoder as jenc
from ide3d_tpu.models.layers import Conv2dLayer as JConv2dLayer
from ide3d_tpu.utils import seg as jseg
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models import encoder as tenc
from ide3d_tpu_torch.models.layers import Conv2dLayer
from ide3d_tpu_torch.utils import seg as tseg
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

ATOL = 2e-4  # the golden test's own tolerance


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_close(name, got, ref, atol=ATOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all(), f"{name}: non-finite values"
    assert np.isfinite(ref).all(), f"{name}: non-finite reference"
    assert got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}"
    np.testing.assert_allclose(got, ref, atol=atol, rtol=atol, err_msg=name)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


CONV_CASES = [dict(bias=b, activation=a, down=d, kernel_size=k)
              for b, a, d, k in itertools.product((True, False), ("lrelu", "linear"), (1, 2), (1, 3))]
CONV_CASES += [dict(bias=True, activation="lrelu", up=2, kernel_size=3, conv_clamp=0.5, gain=2.0),
               dict(bias=False, activation="lrelu", down=2, kernel_size=3, conv_clamp=0.3, gain=0.5)]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
@torch.inference_mode()
def test_conv2d_layer_matches_jax(case):
    case = dict(case)
    gain = case.pop("gain", 1.0)
    k = case.pop("kernel_size")
    jl = JConv2dLayer(5, 7, k, **case)
    params = jl.init(jax.random.PRNGKey(3))
    # non-zero biases, so that a missing or misplaced bias shows
    if case["bias"]:
        params["bias"] = jnp.linspace(-0.5, 0.5, 7)
    layer = load_jax_params(Conv2dLayer(5, 7, k, **case), _np_tree(params))
    assert ("bias" in dict(layer.named_parameters())) == case["bias"]
    x = np.random.RandomState(0).randn(2, 8, 8, 5).astype(np.float32)
    ref = np.asarray(jl(params, jnp.asarray(x), gain=gain))
    got = layer(_nchw(x), gain=gain).permute(0, 2, 3, 1).numpy()
    _assert_close(f"Conv2dLayer {case}", got, ref)


@torch.inference_mode()
def test_encoder_res_block_matches_jax():
    jb = jenc.EncoderResBlock(6, 10)
    params = jb.init(jax.random.PRNGKey(4))
    params["conv1"]["bias"] = jnp.full((6,), 0.1)
    params["conv2"]["bias"] = jnp.full((10,), -0.2)
    block = load_jax_params(tenc.EncoderResBlock(6, 10), _np_tree(params))
    x = np.random.RandomState(1).randn(2, 16, 16, 6).astype(np.float32)
    ref = np.asarray(jb(params, jnp.asarray(x)))
    got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 8, 8, 10)
    _assert_close("EncoderResBlock", got, ref)


@pytest.fixture(scope="module")
def bridged_hybrid():
    """(JAX HybridEncoder(size=32), its params, the port's encoder with them)."""
    jE = jenc.HybridEncoder(size=32, n_latents_app=8, n_latents_geo=4)
    params = jax.jit(jE.init)(jax.random.PRNGKey(1))
    E = load_jax_params(tenc.HybridEncoder(size=32, n_latents_app=8, n_latents_geo=4),
                        _np_tree(params))
    return jE, params, E.eval()


@torch.inference_mode()
def test_hybrid_encoder_matches_jax(bridged_hybrid):
    """fp32 ws [B, geo+app, 512], geometry (seg) rows first."""
    jE, params, E = bridged_hybrid
    rng = np.random.RandomState(2)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    seg = np.asarray(jseg.mask2onehot(jnp.asarray(rng.randint(0, 19, (2, 32, 32))))) * 2 - 1
    ref = np.asarray(jax.jit(jE)(params, jnp.asarray(img), jnp.asarray(seg)))
    got = E(torch.from_numpy(img), torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 512)
    _assert_close("HybridEncoder", got.numpy(), ref)
    # the seg pyramid alone gives the first 4 rows
    seg_rows = E.seg(_nchw(seg)).reshape(2, 4, 512)
    _assert_close("seg rows first", got[:, :4].numpy(), seg_rows.numpy(), atol=0)


@torch.inference_mode()
def test_encoder_matches_jax():
    jE = jenc.Encoder(size=16, n_latents=3, input_dim=4)
    params = jE.init(jax.random.PRNGKey(5))
    E = load_jax_params(tenc.Encoder(size=16, n_latents=3, input_dim=4), _np_tree(params))
    x = np.random.RandomState(3).randn(2, 16, 16, 4).astype(np.float32)
    ref = np.asarray(jax.jit(jE)(params, jnp.asarray(x)))
    _assert_close("Encoder", E(torch.from_numpy(x)).numpy(), ref)


@torch.inference_mode()
def test_hybrid_encoder_bf16_returns_fp32(bridged_hybrid):
    """The card runs E in bf16 (G's dtype); its output is fp32 and stays near
    the fp32 encoder's (0.7% of the output's scale here; bound 3%)."""
    _, params, E32 = bridged_hybrid
    E16 = load_jax_params(tenc.HybridEncoder(size=32, n_latents_app=8, n_latents_geo=4,
                                             dtype="bfloat16"), _np_tree(params))
    rng = np.random.RandomState(4)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32))
    seg = tseg.mask2onehot(torch.from_numpy(rng.randint(0, 19, (1, 32, 32)))) * 2 - 1
    ref, got = E32(img, seg), E16(img, seg)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 0.03 * float(ref.abs().max())


def test_hybrid_encoder_tree_must_match(bridged_hybrid):
    """A missing or an extra leaf raises: the bias-less skip has no bias leaf."""
    _, params, _ = bridged_hybrid
    tree = _np_tree(params)
    assert "bias" not in tree["img"]["block0"]["skip"]
    assert tree["img"]["projector"]["weight"].shape == (4, 4, 512, 8 * 512)
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["img"]["block0"]["skip"]["bias"] = np.zeros(512, np.float32)
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(tenc.HybridEncoder(size=32, n_latents_app=8, n_latents_geo=4), extra)
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["seg"]["projector"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(tenc.HybridEncoder(size=32, n_latents_app=8, n_latents_geo=4), missing)


def test_encoder_init_is_seeded():
    a = tenc.HybridEncoder(size=8, n_latents_app=2, n_latents_geo=1).init(1).state_dict()
    b = tenc.HybridEncoder(size=8, n_latents_app=2, n_latents_geo=1).init(1).state_dict()
    c = tenc.HybridEncoder(size=8, n_latents_app=2, n_latents_geo=1).init(2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["img.projector.weight"], c["img.projector.weight"])
    assert torch.equal(a["seg.stem.bias"], torch.zeros(512))
    assert "img.block0.skip.bias" not in a


def test_mask2onehot_matches_jax():
    mask = np.random.RandomState(5).randint(0, 19, (2, 6, 7)).astype(np.uint8)
    ref = np.asarray(jseg.mask2onehot(jnp.asarray(mask)))
    got = tseg.mask2onehot(torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tseg.onehot2mask(got).numpy(),
                                  np.asarray(jseg.onehot2mask(jnp.asarray(ref))))
    assert tseg.NUM_CLASSES == jseg.NUM_CLASSES and tseg.LABEL_LIST == jseg.LABEL_LIST
    np.testing.assert_array_equal(tseg.COLOR_MAP, jseg.COLOR_MAP)
