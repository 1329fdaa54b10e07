"""The port's face networks (models/arcface.py, bisenet.py, e4e.py and their
readers in io/torch_import.py) against the JAX package, on the CPU.

Weights come from the JAX package's random inits, bridged through
io/from_jax.py; the port's own ArcFace and BiSeNet `init()` draw the same
numbers in the same order, which the tests check too. Each network runs at the smallest input its
architecture takes: ArcFace's embed_faces on a 32² image (the crop is resized
to 112²), BiSeNet at 32² (the /32 map is 1x1, so the align-corners upsamples
meet their 1-wide axes), e4e at 32² with stylegan_size 32 (8 rows: coarse,
middle and fine heads). ArcFace and e4e run with their convs at half the JAX
init's std: at the init's std the IR-SE50 body grows activations ~1e6-fold
over its 24 blocks, and the port in fp32 differs from itself in fp64 by 6e-3
of the output there; at half the std the activations stay O(1).
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu.models.arcface import ArcFaceIRSE50 as JArcFace
from ide3d_tpu.models.bisenet import BiSeNet as JBiSeNet
from ide3d_tpu.models.bisenet import _resize_bilinear_ac as j_resize_ac
from ide3d_tpu.models.e4e import E4eEncoder as JE4eEncoder
from ide3d_tpu.models.e4e import pivot_from_image as j_pivot
from ide3d_tpu_torch.io import import_bisenet, load_torch_file_stubbed
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.metrics.features import load_state_dict_file
from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
from ide3d_tpu_torch.models.bisenet import BiSeNet, resize_bilinear_ac
from ide3d_tpu_torch.models.e4e import E4eEncoder, load_e4e, pivot_from_image
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

TOL = 1e-5  # x max|output|: fp32, the order of sums apart


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _half_std(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.5 if path[-1].key == "weight" and x.ndim == 4 else x, tree)


def _bridge(module, tree):
    return load_jax_params(module, _np(tree)).eval()


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def rel_close(got, ref, tol=TOL, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (name, err, scale)


def _images(n, size, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def arcface():
    jnet = JArcFace()
    tree = jnet.init()
    net = _bridge(ArcFaceIRSE50(), tree)
    own = ArcFaceIRSE50().init()
    assert _same_weights(net, own)  # the port's init() is the JAX init
    return jnet, _half_std(tree), own


def test_arcface_embed_faces_matches_jax(arcface):
    jnet, tree, _ = arcface
    x = _images(2, 32)
    ref = jax.jit(jnet.embed_faces)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = _bridge(ArcFaceIRSE50(), tree).embed_faces(torch.from_numpy(x))
    assert got.shape == (2, 512)
    rel_close(got, ref, name="embed_faces")


def test_arcface_loads_a_torch_state_dict_file(arcface, tmp_path):
    """model_ir_se50.pth layout: the BN counters are skipped, a missing tensor
    raises (the file in fp16, to keep it small: the module converts)."""
    net = arcface[2]
    sd = {k: (v + 0.01).half() for k, v in net.state_dict().items()}
    sd["input_layer.1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "ir_se50.pth")
    got = load_state_dict_file(ArcFaceIRSE50(), str(tmp_path / "ir_se50.pth"))
    assert all(torch.equal(got.state_dict()[k], sd[k].float()) for k in net.state_dict())
    del sd["output_layer.3.weight"]
    torch.save(sd, tmp_path / "partial.pth")
    with pytest.raises(KeyError, match="output_layer.3.weight"):
        load_state_dict_file(ArcFaceIRSE50(), str(tmp_path / "partial.pth"))


@pytest.fixture(scope="module")
def bisenet():
    jnet = JBiSeNet(20)
    tree = jnet.init(None)
    net = _bridge(BiSeNet(20), tree)
    assert _same_weights(net, BiSeNet(20).init())
    return jnet, tree, net


def test_bisenet_matches_jax(bisenet):
    jnet, tree, net = bisenet
    x = _images(2, 32, seed=1)
    ref = jax.jit(jnet.__call__)(tree, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 20)
    rel_close(got, ref, name="bisenet logits")


def test_import_bisenet_reads_the_checkpoint_layout(bisenet, tmp_path):
    """segNet-20Class.pth: the state dict with the auxiliary heads (conv_out16,
    conv_out32) and BN counters, read with weights_only=True."""
    _, _, net = bisenet
    sd = dict(net.state_dict())
    sd["conv_out16.conv_out.weight"] = torch.zeros(20, 64, 1, 1)
    sd["cp.resnet.bn1.num_batches_tracked"] = torch.tensor(3)
    torch.save(sd, tmp_path / "segNet-20Class.pth")
    got = import_bisenet(str(tmp_path / "segNet-20Class.pth"), device="cpu")
    assert _same_weights(got, net) and not got.training


@pytest.mark.parametrize("shape,size", [((1, 1), (4, 4)), ((1, 3), (4, 5)), ((4, 4), (1, 1)),
                                        ((2, 3), (5, 1)), ((3, 5), (6, 9)), ((8, 8), (4, 4))])
def test_resize_bilinear_ac_matches_jax(shape, size):
    """F.interpolate(align_corners=True) against the JAX package's emulation,
    the degenerate 1-wide axes included."""
    x = np.random.RandomState(2).randn(2, *shape, 3).astype(np.float32)
    got = resize_bilinear_ac(torch.from_numpy(x).permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    ref = jax.jit(j_resize_ac, static_argnums=1)(jnp.asarray(x), size)
    rel_close(got, ref, 1e-6, f"{shape}->{size}")


@pytest.fixture(scope="module")
def e4e_tree():
    return _half_std(JE4eEncoder(stylegan_size=32, variant="e4e").init())


@pytest.mark.parametrize("variant", ["e4e", "gradual"])
def test_e4e_matches_jax(e4e_tree, variant):
    jnet = JE4eEncoder(stylegan_size=32, variant=variant)
    x = _images(1, 32, seed=3)
    avg = np.linspace(-1, 1, 512, dtype=np.float32)
    ref = jax.jit(lambda p, im: j_pivot(jnet, p, jnp.asarray(avg), im))(e4e_tree, jnp.asarray(x))
    net = _bridge(E4eEncoder(32, variant), e4e_tree)
    with torch.no_grad():
        got = pivot_from_image(net, torch.from_numpy(avg), torch.from_numpy(x))
    assert got.shape == (1, 8, 512)
    rel_close(got, ref, name=f"{variant} codes")


class _Trap:
    """Unpickling this through pickle's own rules calls os.mkdir(path)."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return os.mkdir, (self.path,)


def test_stub_reader_reads_opts_without_running_pickled_code(tmp_path):
    """load_torch_file_stubbed: tensors come back, an argparse Namespace as its
    fields, a reconstructor in the file is not called."""
    marker = str(tmp_path / "ran")
    torch.save({"t": torch.arange(6, dtype=torch.float16).reshape(2, 3), "trap": _Trap(marker),
                "opts": argparse.Namespace(encoder_type="GradualStyleEncoder", lr=1e-4)},
               tmp_path / "a.pt")
    raw = load_torch_file_stubbed(str(tmp_path / "a.pt"))
    assert not os.path.exists(marker)
    assert raw["opts"]["encoder_type"] == "GradualStyleEncoder" and raw["opts"]["lr"] == 1e-4
    assert torch.equal(raw["t"], torch.arange(6, dtype=torch.float16).reshape(2, 3))


def test_load_e4e_takes_the_variant_from_opts(tmp_path):
    """opts.encoder_type (a Namespace or a dict) picks the variant; without
    opts the loader warns and takes 'e4e'. stylegan_size 4 (2 heads) in fp16:
    the smallest file."""
    net = E4eEncoder(4, "e4e")
    with torch.no_grad():  # cheap distinct values: the weights' meaning does not matter here
        for i, v in enumerate(net.state_dict().values()):
            v.copy_(torch.linspace(-1, 1, v.numel()).reshape(v.shape) * (1 + i % 7))
    sd = {f"encoder.{k}": v.half() for k, v in net.state_dict().items()}
    want_sd = {k: v.half().float() for k, v in net.state_dict().items()}
    avg = torch.linspace(-1, 1, 512)
    path = str(tmp_path / "e.pt")
    for opts, want in ((argparse.Namespace(encoder_type="GradualStyleEncoder"), "gradual"),
                       ({"encoder_type": "Encoder4Editing"}, "e4e"), (None, "e4e")):
        obj = {"state_dict": sd, "latent_avg": avg}
        if opts is not None:
            obj["opts"] = opts
        torch.save(obj, path)
        if opts is None:
            with pytest.warns(UserWarning, match="encoder_type"):
                model, got_avg, report = load_e4e(path)
            assert load_e4e(path, variant="gradual")[0].variant == "gradual"
        else:
            model, got_avg, report = load_e4e(path)
        assert model.variant == want == report.variant and report.has_latent_avg
        assert report.stylegan_size == 4 and report.style_count == 2
        assert all(torch.equal(model.state_dict()[k], v) for k, v in want_sd.items())
        torch.testing.assert_close(got_avg, avg)
