"""The port's reference-checkpoint import (ide3d_tpu_torch/io/torch_import.py)
against the JAX package's (ide3d_tpu/io/torch_import.py), on the CPU.

The fixture pickle is the one tests/test_import_parity.py builds: a
reference-shaped G_ema, D and HybridEncoder whose classes live in a module
that is gone when the pickle is read, so both importers go through their stub
unpicklers. Both must infer the same configuration and give the same
ImportReport, and the imported modules must compute the same functions
(<= 2e-4 x max(1, |output|), fp32)."""

import dataclasses
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ide3d_tpu.io.torch_import as jimport
import ide3d_tpu.models.encoder as jencoder
import ide3d_tpu_torch.models.encoder as tencoder
from ide3d_tpu import render as jrender
from ide3d_tpu.models.discriminator import minibatch_stddev as j_mbstd
from ide3d_tpu_torch.io import torch_import as timport
from ide3d_tpu_torch.io.from_jax import load_jax_params
from test_import_parity import (
    C_DIM, FCH, SCH, W_DIM, Z_DIM, TConv2dLayer, TDBlock, TEncResBlock, TFC, TinyD, TinyG,
    TinyHybridEncoder, TinySynthesis, TMapping, TSegBlock, TSynthBlock, TSynthesisLayer, TToRGB,
    _randomize,
)
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)


ENC_CHANNELS = {16: 8, 8: 10, 4: 12}  # the fixture encoder's narrowed schedule
GEN_KW = dict(render_size=8, num_steps=4, dtype="float32")
FIXTURE_CLASSES = (TinyG, TinySynthesis, TSegBlock, TSynthBlock, TSynthesisLayer, TToRGB, TFC,
                   TMapping, TinyD, TDBlock, TConv2dLayer, TinyHybridEncoder, TEncResBlock)


def _close(name, got, ref, tol=2e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def _dump_with_fake_module(path, payload, module_name):
    """Pickle `payload` with the fixture classes under `module_name`, then
    remove that module, as a reference pickle's classes are absent at load."""
    fake = types.ModuleType(module_name)
    orig = {}
    for cls in FIXTURE_CLASSES:
        setattr(fake, cls.__name__, cls)
        orig[cls] = cls.__module__
        cls.__module__ = module_name
    sys.modules[module_name] = fake
    try:
        with open(path, "wb") as f:
            pickle.dump(payload, f)
    finally:
        del sys.modules[module_name]
        for cls, mod in orig.items():
            cls.__module__ = mod


@pytest.fixture(scope="module")
def narrow_encoders():
    """Both packages' encoder channel tables narrowed to the fixture's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jencoder, "_CHANNELS", ENC_CHANNELS)
        mp.setattr(tencoder, "_CHANNELS", ENC_CHANNELS)
        yield


@pytest.fixture(scope="module")
def fixture_nets():
    torch.manual_seed(0)
    g = TinyG()
    _randomize(g, 1)
    torch.manual_seed(9)
    d = TinyD()
    _randomize(d, 10)
    e = TinyHybridEncoder(ENC_CHANNELS, n_app=3, n_geo=2, w_dim=W_DIM)
    _randomize(e, 11)
    return g, d, e


@pytest.fixture(scope="module")
def imported(tmp_path_factory, fixture_nets, narrow_encoders):
    """(JAX load_network_pkl result, the port's) of one fixture pickle."""
    g, d, e = fixture_nets
    path = tmp_path_factory.mktemp("pkl") / "net.pkl"
    _dump_with_fake_module(path, {"G_ema": g, "D": d, "E": e, "training_set_kwargs": {"path": "x"}},
                           "fake_pickled_networks_torch_import")
    out_j = jimport.load_network_pkl(str(path), **GEN_KW)
    out_t = timport.load_network_pkl(str(path), device="cpu", **GEN_KW)
    return out_j, out_t


def _same_report(rj, rt):
    assert dataclasses.asdict(rt) == dataclasses.asdict(rj)


def test_pickle_reads_to_the_same_state_dicts(tmp_path, fixture_nets):
    g = fixture_nets[0]
    path = tmp_path / "g.pkl"
    _dump_with_fake_module(path, {"G_ema": g}, "fake_pickled_networks_torch_import_sd")
    sj = jimport.pickle_payload_to_state_dicts(jimport.load_pickle_tensors(str(path)))
    st = timport.pickle_payload_to_state_dicts(timport.load_pickle_tensors(str(path)))
    assert set(st) == set(sj) == {"G_ema"}
    assert list(st["G_ema"]) == list(sj["G_ema"])
    for k, v in sj["G_ema"].items():
        np.testing.assert_array_equal(st["G_ema"][k], v)


def test_persistent_object_records_are_read(tmp_path, fixture_nets):
    """The reference pickles a network as a call of its persistence module's
    `_reconstruct_persistent_obj` on a record whose `state` is the module's
    __dict__; the record is stubbed (the call never runs) and walked."""
    g = fixture_nets[0]
    fake = types.ModuleType("fake_persistence")

    def _reconstruct_persistent_obj(meta):
        raise AssertionError("a pickle's code ran")

    _reconstruct_persistent_obj.__module__ = "fake_persistence"
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    fake._reconstruct_persistent_obj = _reconstruct_persistent_obj

    class Record:
        def __reduce__(self):
            meta = dict(type="class", version=6, module_src="", class_name="Generator",
                        state=g.__dict__)
            return _reconstruct_persistent_obj, (meta,)

    sys.modules["fake_persistence"] = fake
    try:
        _dump_with_fake_module(tmp_path / "p.pkl", {"G_ema": Record()}, "fake_networks_persistent")
    finally:
        del sys.modules["fake_persistence"]
    st = timport.pickle_payload_to_state_dicts(timport.load_pickle_tensors(str(tmp_path / "p.pkl")))
    want = {k: v.numpy() for k, v in g.state_dict().items()}
    assert set(st) == {"G_ema"} and set(st["G_ema"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(st["G_ema"][k], v)


def test_imported_config_and_reports_match_jax(imported):
    out_j, out_t = imported
    assert set(out_t) == set(out_j) == {"G_ema", "D", "E"}
    for key in out_j:
        assert not isinstance(out_t[key], Exception), out_t[key]
        _same_report(out_j[key][2], out_t[key][1])
    (jG, _, rep), (G, _) = out_j["G_ema"], out_t["G_ema"]
    assert rep.skipped_source == () and len(rep.missing_dest) == 4
    for f in dataclasses.fields(G.cfg):
        want = getattr(jG.cfg, f.name)
        got = getattr(G.cfg, f.name)
        if f.name == "render":
            assert {k: getattr(want, k) for k in dataclasses.asdict(got)} == dataclasses.asdict(got)
        else:
            assert got == want, f.name
    assert G.num_ws == jG.num_ws and G.synthesis.num_ws_geo == jG.synthesis.num_ws_geo == 4
    (jD, _, _), (D, _) = out_j["D"], out_t["D"]
    for f in dataclasses.fields(D.cfg):
        assert getattr(D.cfg, f.name) == getattr(jD.cfg, f.name), f.name
    (jE, _, _), (E, _) = out_j["E"], out_t["E"]
    assert (E.n_latents_app, E.n_latents_geo) == (jE.n_latents_app, jE.n_latents_geo) == (3, 2)


def test_imported_generator_matches_jax(imported):
    (jG, jp, rep), (G, _) = imported[0]["G_ema"], imported[1]["G_ema"]
    # The renderer decoder has no reference names: both importers leave it
    # at their own seeded init (missing_dest); give the port JAX's.
    assert rep.missing_dest
    G = G.__class__(G.cfg)
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, jp))
    G_imp = imported[1]["G_ema"][0]
    with torch.no_grad():
        for name, t in G_imp.state_dict().items():
            if not name.startswith("synthesis.renderer."):
                assert torch.equal(G.state_dict()[name], t), name
    rng = np.random.RandomState(0)
    z = rng.randn(3, Z_DIM).astype(np.float32)
    c = rng.randn(3, C_DIM).astype(np.float32)
    with torch.no_grad():
        for kw in ({}, {"truncation_psi": 0.6, "truncation_cutoff": 3}):
            want = jax.jit(lambda p, z, c: jG.mapping(p, z, c, **kw))(
                jp["mapping"], jnp.asarray(z), jnp.asarray(c))
            _close(f"mapping {kw}", G.mapping(torch.from_numpy(z), torch.from_numpy(c), **kw), want)
        ws = rng.randn(2, G.num_ws, W_DIM).astype(np.float32)
        for got, want in zip(G.synthesis.generate_planes(torch.from_numpy(ws)),
                             jax.jit(jG.synthesis.generate_planes)(jp["synthesis"], jnp.asarray(ws))):
            _close("planes", got, want)
        cam = np.repeat(np.asarray(jrender.CANONICAL_POSE_25)[None], 2, 0)
        got = G.synthesis(torch.from_numpy(ws), torch.from_numpy(cam), return_all=True)
    want = jax.jit(lambda p, w, c: jG.synthesis(p, w, c, return_all=True))(
        jp["synthesis"], jnp.asarray(ws), jnp.asarray(cam))
    for k in ("img", "img_raw", "seg", "depth", "weights_sum"):
        _close(f"synthesis {k}", got[k], want[k])


def test_imported_discriminator_matches_jax(imported):
    (jD, jp, _), (D, _) = imported[0]["D"], imported[1]["D"]
    rng = np.random.RandomState(4)
    img = rng.randn(4, 16, 16, TinyD.IMG_CH).astype(np.float32)
    c = rng.randn(4, C_DIM).astype(np.float32)
    # The epilogue's output before the projection: the flatten order of its
    # fc input shows here (the projected logit nearly cancels, ~1e-4).
    seen = {}
    D.b4.out.register_forward_hook(lambda m, i, o: seen.setdefault("out", o))
    with torch.no_grad():
        logits = D(torch.from_numpy(img), torch.from_numpy(c))
    conv, fc, out = jD._epilogue()._layers()

    @jax.jit
    def jax_d(p, img, c):
        x = jD._block(8)(p["b8"], jD._block(16)(p["b16"], None, img), None)
        x = conv(p["b4"]["conv"], j_mbstd(x.astype(jnp.float32), 4, 1))
        return out(p["b4"]["out"], fc(p["b4"]["fc"], x.reshape(4, -1))), jD(p, img, c)

    xo_j, logits_j = jax_d(jp, jnp.asarray(img), jnp.asarray(c))
    _close("epilogue out", seen["out"], xo_j)
    _close("logits", logits, logits_j)


def test_imported_encoder_matches_jax(imported):
    (jE, jp, _), (E, _) = imported[0]["E"], imported[1]["E"]
    rng = np.random.RandomState(8)
    img = rng.randn(2, 16, 16, 3).astype(np.float32)
    seg = rng.randn(2, 16, 16, SCH).astype(np.float32)
    with torch.no_grad():
        got = E(torch.from_numpy(img), torch.from_numpy(seg))
    want = jE(jp, jnp.asarray(img), jnp.asarray(seg))
    _close("encoder ws", got, want)
    _close("encoder geometry rows", got[:, :2], np.asarray(want)[:, :2])
    _close("encoder appearance rows", got[:, 2:], np.asarray(want)[:, 2:])


def _sd_with_decoder(g):
    sd = {k: v.numpy() for k, v in g.state_dict().items()}
    rs = np.random.RandomState(0)
    sd.update({
        "synthesis.renderer.net.0.weight": (rs.randn(64, FCH) * 0.05).astype(np.float32),
        "synthesis.renderer.net.0.bias": rs.randn(64).astype(np.float32),
        "synthesis.renderer.net.2.weight": (rs.randn(FCH + 1, 64) * 0.05).astype(np.float32),
        "synthesis.renderer.net.2.bias": rs.randn(FCH + 1).astype(np.float32),
    })
    return sd


def test_renderer_decoder_auto_map_matches_jax(fixture_nets):
    """A decoder under unknown names is recovered by shape (with the
    equalized-lr rescale): same report, and nothing left at init, so the
    whole frame must agree."""
    sd = _sd_with_decoder(fixture_nets[0])
    jG, jp, rj = jimport.import_generator(sd, **GEN_KW)
    G, rt = timport.import_generator(sd, device="cpu", **GEN_KW)
    _same_report(rj, rt)
    assert len(rt.auto_mapped) == 4 and rt.missing_dest == ()
    for name in ("dec_w1", "dec_b1", "dec_w2", "dec_b2"):
        np.testing.assert_array_equal(getattr(G.synthesis.renderer, name).detach().numpy(),
                                      np.asarray(jp["synthesis"]["renderer"][name]))
    rng = np.random.RandomState(3)
    z = rng.randn(2, Z_DIM).astype(np.float32)
    cam = np.repeat(np.asarray(jrender.CANONICAL_POSE_25)[None], 2, 0)
    with torch.no_grad():
        got = G(torch.from_numpy(z), torch.from_numpy(cam), return_seg=True)
    want = jax.jit(lambda p, z, c: jG(p, z, c, return_seg=True))(jp, jnp.asarray(z),
                                                                  jnp.asarray(cam))
    _close("img", got[0], want[0])
    _close("seg", got[1], want[1])


def test_extra_map_and_ambiguous_shapes_match_jax(fixture_nets):
    sd = {k: v.numpy() for k, v in fixture_nets[0].state_dict().items()}
    rs = np.random.RandomState(1)
    custom = rs.randn(64, FCH).astype(np.float32)  # torch [out, in]
    sd2 = dict(sd, **{"synthesis.renderer.mlp.0.weight": custom,
                      "synthesis.renderer.a": rs.randn(64).astype(np.float32),
                      "synthesis.renderer.b": rs.randn(64).astype(np.float32)})
    dest = ("synthesis", "renderer", "dec_w1")
    _, jp, rj = jimport.import_generator(sd2, extra_map={"synthesis.renderer.mlp.0.weight": dest},
                                         **GEN_KW)
    G, rt = timport.import_generator(sd2, extra_map={"synthesis.renderer.mlp.0.weight": dest},
                                     device="cpu", **GEN_KW)
    _same_report(rj, rt)
    assert "synthesis.renderer.a" in rt.skipped_source and "synthesis.renderer.b" in rt.skipped_source
    np.testing.assert_array_equal(G.synthesis.renderer.dec_w1.detach().numpy(), custom.T)


def test_tf_legacy_payload_raises(tmp_path):
    """A (G, D, Gs) tuple of tflib Network states (their pickled fields) goes
    to io/tf_legacy.py; variables that are not a StyleGAN2's make each entry
    raise there, and load_network_pkl reports each entry's error
    (tests/test_torch_tf_legacy.py converts real ones)."""
    Network = type("Network", (), {"__module__": "fake_tflib_network"})
    mod = types.ModuleType("fake_tflib_network")
    mod.Network = Network
    nets = []
    for _ in range(3):
        n = Network()
        n.version, n.static_kwargs, n.variables = 5, {"resolution": 16}, [("w", np.zeros(2))]
        nets.append(n)
    sys.modules["fake_tflib_network"] = mod
    try:
        path = tmp_path / "tf.pkl"
        with open(path, "wb") as f:
            pickle.dump(tuple(nets), f)
    finally:
        del sys.modules["fake_tflib_network"]
    out = timport.load_network_pkl(str(path), device="cpu")
    assert sorted(out) == ["D", "G", "G_ema"]
    for key, err in out.items():
        assert isinstance(err, KeyError), (key, err)


_CALLS = []


def _record_call(*args):
    _CALLS.append(args)
    return args


class _RunsCode:
    def __reduce__(self):
        return (_record_call, ("ran",))


def test_reading_a_pickle_runs_none_of_its_code(tmp_path):
    """The reference's pickles carry their classes as code. A pickle whose
    object reconstructs through a function of an importable module: the
    stub unpickler must not call it."""
    path = tmp_path / "code.pkl"
    with open(path, "wb") as f:
        pickle.dump({"G": _RunsCode(), "meta": 1}, f)
    payload = timport.load_pickle_tensors(str(path))
    assert _CALLS == []
    assert payload["meta"] == 1 and type(payload["G"]).__name__ == "_record_call"
    assert timport.pickle_payload_to_state_dicts(payload) == {}
    with open(path, "rb") as f:  # a plain unpickler would have run it
        pickle.load(f)
    assert _CALLS == [("ran",)]


@pytest.mark.parametrize("raw_head", ["slice", "torgb"])
def test_ref_compat_generator_matches_jax(raw_head):
    """The reference-compat generator, initialised by JAX and bridged through
    io/from_jax: its row counts, planes and frame against JAX, and the
    pose-only plane cache (`table=`) against the uncached frame, exactly."""
    from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
    from ide3d_tpu.models import Ide3dGenerator as JGenerator
    from ide3d_tpu.render.renderer import RenderParams as JRenderParams
    from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
    from ide3d_tpu_torch.render.renderer import RenderParams

    kw = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
              channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
              dtype="float32", vb_ref_compat=True, raw_head=raw_head, mapping_num_layers=3)
    jG = JGenerator(JGeneratorConfig(**kw, render=JRenderParams(img_size=8, num_steps=4)))
    jp = jax.jit(jG.init)(jax.random.PRNGKey(1))
    G = Ide3dGenerator(GeneratorConfig(**kw, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, jp))
    # 3 vb blocks advance 1 + 2 + 2 rows; 3 superres blocks take 2 each + 1 ToRGB.
    assert G.num_ws == jG.num_ws == 12 + (raw_head == "torgb")
    assert G.synthesis.num_ws_geo == jG.synthesis.num_ws_geo == 6
    assert (G.synthesis.raw_rgb is None) == (raw_head == "slice")

    rng = np.random.RandomState(5)
    ws = rng.randn(2, G.num_ws, 512).astype(np.float32)
    cam = np.repeat(np.asarray(jrender.CANONICAL_POSE_25)[None], 2, 0)
    with torch.no_grad():
        planes = G.synthesis.generate_planes(torch.from_numpy(ws))
        got = G.synthesis(torch.from_numpy(ws), torch.from_numpy(cam), return_all=True)
        table = G.synthesis.plane_table(torch.from_numpy(ws))
        cached = G.synthesis(torch.from_numpy(ws), torch.from_numpy(cam), return_all=True,
                             table=table)
    want_planes, want = jax.jit(lambda p, w, c: (
        jG.synthesis.generate_planes(p, w), jG.synthesis(p, w, c, return_all=True)))(
        jp["synthesis"], jnp.asarray(ws), jnp.asarray(cam))
    for g, w in zip(planes, want_planes):
        _close("planes", g, w)
    for k in ("img", "img_raw", "seg", "depth", "weights_sum"):
        _close(f"synthesis {k}", got[k], want[k])
        assert torch.equal(cached[k], got[k]), k
