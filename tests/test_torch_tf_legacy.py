"""TF1-era StyleGAN2 pickles and JAX snapshots into the port, on the CPU.

The port's io/tf_legacy.py and models/stylegan2.py against the JAX
package's: the (G, D, Gs) pickle of tflib Network states is written by the
JAX test's fixture functions (tests/test_tf_legacy.py: tiny framework networks
inverse-mapped into TF-layout variables). Both packages' load_network_pkl
must give the same parameters, bit for bit, and the same outputs (fp32,
<= 1e-5 x max(1, |output|)). Then tools/jax_ckpt_to_torch.py: a tiny JAX
snapshot (orbax) converted and loaded by the port's load_generator renders
what the JAX G renders (<= 1e-4 x max(1, |image|))."""

import dataclasses
import importlib.util
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import ide3d_tpu.io.tf_legacy as jtf
import ide3d_tpu.io.torch_import as jimport
from ide3d_tpu import render as jrender
from ide3d_tpu.models.stylegan2 import StyleGan2Generator as JGenerator
from ide3d_tpu_torch.io import tf_legacy as ttf
from ide3d_tpu_torch.io import torch_import as timport
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.discriminator import Discriminator
from ide3d_tpu_torch.models.stylegan2 import StyleGan2Generator
from test_tf_legacy import G_CFG, RES, W, _install_tflib_shim, _make_tf_pickle, _tf_g_variables
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(name, got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def _same_state(module, ref):
    a, b = module.state_dict(), ref.state_dict()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)


def _same_config(cfg, jcfg):
    """Every field of the port's StyleGan2Config equals the JAX config's; the
    JAX fields the port lacks are its w_avg EMA rate, which no caller of the
    port updates, and its compute dtype, which the import keeps at fp32."""
    port, ref = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    assert port == {k: ref[k] for k in port}
    assert set(ref) - set(port) == {"w_avg_beta", "dtype"} and jcfg.dtype == "float32"


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The JAX test's tiny nets as a TF pickle, loaded by both packages:
    (JAX params of G and D, JAX load_network_pkl's dict, the port's, path)."""
    from ide3d_tpu.models.discriminator import Discriminator as JD
    from test_tf_legacy import D_CFG

    g_params = _np(jax.jit(JGenerator(G_CFG).init)(jax.random.PRNGKey(7)))
    d_params = _np(jax.jit(JD(D_CFG).init)(jax.random.PRNGKey(8)))
    # distinguishable mod biases and strengths (the JAX test's offsets)
    g_params = jax.tree_util.tree_map(
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape), g_params)
    path = _make_tf_pickle(tmp_path_factory.mktemp("tf"), g_params, d_params)
    return g_params, d_params, jimport.load_network_pkl(path), timport.load_network_pkl(
        path, device="cpu"), path


def test_tf_pickle_same_parameters(loaded):
    """Every tensor the port hosts equals the JAX import's (bridged), bit for
    bit, and both equal the networks the pickle was written from."""
    g_params, d_params, jout, tout, _ = loaded
    for key in ("G", "G_ema", "D"):
        assert not isinstance(tout[key], Exception), f"{key}: {tout[key]!r}"
        assert tout[key][1].imported > 0
    for key in ("G", "G_ema"):
        jG, jparams, jrep = jout[key]
        G, rep = tout[key]
        _same_config(G.cfg, jG.cfg)
        assert G.cfg.conv_clamp is None and G.cfg.architecture == "skip"
        assert (rep.imported, rep.skipped_source) == (jrep.imported, jrep.skipped_source)
        _same_state(G, load_jax_params(StyleGan2Generator(G.cfg), _np(jparams)))
        _same_state(G, load_jax_params(StyleGan2Generator(G.cfg), g_params))
    jD, jdparams, jdrep = jout["D"]
    D, drep = tout["D"]
    for k in ("c_dim", "img_resolution", "img_channels", "channel_base", "channel_max", "dtype"):
        assert getattr(D.cfg, k) == getattr(jD.cfg, k), k
    assert (drep.imported, drep.skipped_source) == (jdrep.imported, jdrep.skipped_source)
    _same_state(D, load_jax_params(Discriminator(D.cfg), _np(jdparams)))
    _same_state(D, load_jax_params(Discriminator(D.cfg), d_params))


def test_tf_pickle_same_outputs(loaded):
    """G(z) at the const noise and D's logits (fp32) of both packages' imports."""
    from ide3d_tpu.models.discriminator import Discriminator as JD

    _, _, jout, tout, _ = loaded
    z = np.random.RandomState(0).randn(2, W).astype(np.float32)
    jG, jparams, _ = jout["G_ema"]
    G, _ = tout["G_ema"]
    want = np.asarray(jax.jit(lambda p, z: jG(p, z))(jparams, z))
    with torch.no_grad():
        img = G(torch.from_numpy(z))
    _close("G_ema(z)", img.numpy(), want)
    assert img.shape == (2, RES, RES, 3) and G.num_ws == jG.num_ws == 2 * len(G.block_resolutions)

    jD, jdparams, _ = jout["D"]
    D, _ = tout["D"]
    jD32 = JD(dataclasses.replace(jD.cfg, dtype="float32"))
    D32 = Discriminator(dataclasses.replace(D.cfg, dtype="float32"))
    D32.load_state_dict(D.state_dict())
    want = np.asarray(jax.jit(lambda p, x: jD32(p, x, None))(jdparams, want))
    with torch.no_grad():
        logits = D32(img, None)
    _close("D(img)", logits.numpy(), want)


def test_tf_orig_generator_converts(tmp_path):
    """A progressive-era checkpoint (its last ToRGB named ToRGB_lod0, a
    ToRGB_lod1 leftover) converts into the 'orig' architecture in both
    packages: the same parameters (the leftover dropped) and the same image."""
    skip = _np(jax.jit(JGenerator(G_CFG).init)(jax.random.PRNGKey(9)))
    v = {k: a for k, a in _tf_g_variables(skip).items() if "/ToRGB/" not in k}
    tr = skip["synthesis"][f"b{RES}"]["torgb"]
    v.update({"ToRGB_lod0/weight": tr["weight"], "ToRGB_lod0/bias": tr["bias"],
              "ToRGB_lod0/mod_weight": tr["affine"]["weight"],
              "ToRGB_lod0/mod_bias": tr["affine"]["bias"] - 1,
              "ToRGB_lod1/weight": np.ones((1, 1, 32, 3), np.float32),
              "ToRGB_lod1/bias": np.zeros((3,), np.float32),
              "ToRGB_lod1/mod_weight": np.ones((W, 32), np.float32),
              "ToRGB_lod1/mod_bias": np.zeros((32,), np.float32)})
    Network = _install_tflib_shim()
    try:
        tf_g = Network(version=5, name="t", components={}, variables=sorted(v.items()),
                       static_kwargs=dict(latent_size=W, dlatent_size=W, label_size=0,
                                          resolution=RES, num_channels=3, fmap_base=128,
                                          fmap_max=32, mapping_layers=2))
        jG, jparams, jrep = jtf.import_tf_generator(tf_g)
        G, rep = ttf.import_tf_generator(tf_g, device="cpu")
    finally:
        for k in ("dnnlib.tflib.network", "dnnlib.tflib", "dnnlib"):
            del sys.modules[k]
    assert G.cfg.architecture == jG.cfg.architecture == "orig"
    _same_config(G.cfg, jG.cfg)
    assert (rep.imported, rep.skipped_source) == (jrep.imported, jrep.skipped_source)
    assert G.synthesis.b4.torgb is None and G.synthesis.b8.torgb is None
    _same_state(G, load_jax_params(StyleGan2Generator(G.cfg), _np(jparams)))
    z = np.random.RandomState(1).randn(2, W).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jG(p, z))(jparams, z))
    with torch.no_grad():
        _close("orig G(z)", G(torch.from_numpy(z)).numpy(), want)


def test_tf_pickle_version_below_4_rejected(loaded, tmp_path):
    g_params, d_params, _, _, _ = loaded
    out = timport.load_network_pkl(_make_tf_pickle(tmp_path, g_params, d_params, version=3),
                                   device="cpu")
    for key in ("G", "D", "G_ema"):
        assert isinstance(out[key], ValueError) and "version too low" in str(out[key])
    assert not ttf.is_tf_legacy_payload({"G_ema": {}})
    assert not ttf.is_tf_legacy_payload((1, 2, 3))


def test_tf_progressive_discriminator_rejected():
    """A FromRGB_lod discriminator is not hosted, in either package."""
    net = {"version": 5, "static_kwargs": {"resolution": RES}, "components": {},
           "variables": [("FromRGB_lod0/weight", np.zeros((1, 1, 3, 8), np.float32))]}
    for mod in (jtf, ttf):
        with pytest.raises(NotImplementedError, match="FromRGB_lod"):
            mod.convert_tf_discriminator_sd(net)


def test_tf_reader_runs_no_pickled_code(loaded):
    """The TF pickle is read by the stub unpickler: its Network class is not
    importable here, and each network arrives as a dict of its state."""
    *_, path = loaded
    assert "dnnlib" not in sys.modules
    with pytest.raises(ModuleNotFoundError):
        with open(path, "rb") as f:
            pickle.load(f)
    payload = timport.load_pickle_tensors(path)
    assert ttf.is_tf_legacy_payload(payload)
    assert all(isinstance(n, dict) and n["version"] == 5 for n in payload)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "tools", "jax_ckpt_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_jax_snapshot_converts(tmp_path):
    """tools/jax_ckpt_to_torch.py on a tiny JAX snapshot (G and G_ema, as
    train_gan writes them): load_generator reads the result and renders what
    the JAX G_ema renders; step and ada_p are kept."""
    from ide3d_tpu.io.checkpoint import save_checkpoint
    from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
    from ide3d_tpu.models import Ide3dGenerator as JIde3d
    from ide3d_tpu.render.renderer import RenderParams as JRenderParams
    from ide3d_tpu_torch.apps.common import load_generator

    jcfg = JGeneratorConfig(img_resolution=32, render_size=8, plane_resolution=16,
                            channel_base=512, channel_max=32, sr_channel_base=256,
                            sr_channel_max=16, feature_channels=8, dtype="float32",
                            render=JRenderParams(img_size=8, num_steps=4))
    jG = JIde3d(jcfg)
    p_g = _np(jax.jit(jG.init)(jax.random.PRNGKey(0)))
    p_ema = jax.tree_util.tree_map(lambda a: a * 1.01, p_g)
    src, dest = str(tmp_path / "jax_snap"), str(tmp_path / "port_snap")
    save_checkpoint(src, {"G": p_g, "G_ema": p_ema}, config=jcfg, step=7, ada_p=0.25)
    _tool().main(["--src", src, "--dest", dest])

    G = load_generator(dest, device="cpu")
    assert G.cfg.img_resolution == 32 and G.cfg.render.num_steps == 4
    c = np.asarray(jrender.CANONICAL_POSE_25, np.float32)[None]
    z = np.random.RandomState(3).randn(1, 512).astype(np.float32)
    ws = np.asarray(jG.mapping(p_ema["mapping"], z, c))
    want = np.asarray(jax.jit(lambda p, w, c: jG.synthesis(p, w, c))(p_ema["synthesis"], ws, c))
    with torch.no_grad():
        got = G.synthesis(torch.tensor(ws), torch.from_numpy(c)).numpy()
    _close("converted G_ema", got, want, tol=1e-4)
    state = torch.load(os.path.join(dest, "state.pt"), weights_only=True)
    assert sorted(state) == ["G", "G_ema"]
    import json

    meta = json.load(open(os.path.join(dest, "meta.json")))
    assert meta["step"] == 7 and meta["ada_p"] == 0.25


# Every option of the JAX GeneratorConfig and RenderParams off its default.
ALL_OPTIONS = dict(use_encoder=True, encoder_predicts_camera=False, use_feature_volume=True,
                   fv_resolution=8, fv_base_channels=16, sr_arch="sg3")


@pytest.mark.parametrize("case", ["every_option_converts", "unported_field_refused"])
def test_jax_snapshot_with_unported_option_refused(case, tmp_path):
    """A snapshot that sets every option of the JAX config (the hybrid
    volume, the SG3 superres, the built-in encoder without its camera head,
    fine_steps) converts, and the port renders it and encodes as JAX does
    (<= 1e-4 x max(1, |output|)). A JAX config field the port lacks is still
    refused by name: a dataclass derived from the JAX config with one more
    field, at a non-default value, through the tool's _unported."""
    from ide3d_tpu.io.checkpoint import save_checkpoint
    from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
    from ide3d_tpu.models import Ide3dGenerator as JIde3d
    from ide3d_tpu.render.renderer import RenderParams as JRenderParams
    from ide3d_tpu_torch.apps.common import load_generator
    from ide3d_tpu_torch.models.generator import GeneratorConfig

    tool = _tool()
    if case == "unported_field_refused":
        extra = dataclasses.make_dataclass(
            "GeneratorConfig", [("voxel_octree", int, dataclasses.field(default=0))],
            bases=(JGeneratorConfig,), frozen=True)
        assert tool._unported(extra(), GeneratorConfig, "") == []
        assert tool._unported(extra(voxel_octree=3), GeneratorConfig, "") == ["voxel_octree=3"]
        return

    rp = JRenderParams(img_size=8, num_steps=4, fine_steps=6)
    jcfg = JGeneratorConfig(img_resolution=32, render_size=8, plane_resolution=16,
                            channel_base=512, channel_max=32, sr_channel_base=256,
                            sr_channel_max=16, feature_channels=8, dtype="float32",
                            render=rp, **ALL_OPTIONS)
    jG = JIde3d(jcfg)
    params = _np(jax.jit(jG.init)(jax.random.PRNGKey(0)))
    src, dest = str(tmp_path / "jax_snap"), str(tmp_path / "port_snap")
    save_checkpoint(src, {"G_ema": params}, config=jcfg, step=3)
    tool.main(["--src", src, "--dest", dest])

    G = load_generator(dest, device="cpu")
    for k, v in ALL_OPTIONS.items():
        assert getattr(G.cfg, k) == v, k
    assert G.cfg.render.fine_steps == 6 and G.encoder_cam is None
    c = np.asarray(jrender.CANONICAL_POSE_25, np.float32)[None]
    z = np.random.RandomState(3).randn(1, 512).astype(np.float32)
    img = np.random.RandomState(4).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    ws = np.asarray(jax.jit(lambda p, z, c: jG.mapping(p, z, c))(params["mapping"], z, c))
    want = np.asarray(jax.jit(lambda p, w, c: jG.synthesis(p, w, c))(params["synthesis"], ws, c))
    jws = jax.jit(lambda p, x: jG.encode(p, x)[0])(params, img)
    with torch.no_grad():
        got = G.synthesis(torch.tensor(ws), torch.from_numpy(c)).numpy()
        tws, cam = G.encode(torch.from_numpy(img))
    assert cam is None
    _close("converted G, every option", got, want, tol=1e-4)
    _close("converted encoder", tws.numpy(), np.asarray(jws), tol=1e-4)
