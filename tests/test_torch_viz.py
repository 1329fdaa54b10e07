"""The port's interactive leftovers (apps/viz_renderer.py,
apps/infer_face_animation.py, apps/converter_log_to_video.py and
models/encoder.MultiViewHybridEncoder) against the JAX package, on the CPU.

The tiny G of tests/test_train.py (32² out, 8² render), initialised by JAX and
bridged through io/from_jax.py, fp32, at one intra-op thread; the encoders'
weights from the JAX inits, bridged the same way. The CLIs run as a user
calls them, through their mains, with both packages' load_generator and
write_video monkeypatched (as tests/test_torch_offline.py does) and the
port's encoder built from the JAX CLI's init. Images within 1 uint8 level;
floats within 1e-5 x max|output|.
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import ide3d_tpu.apps.common as jcommon
import ide3d_tpu_torch.apps.common as tcommon
from ide3d_tpu.apps import viz_renderer as jviz
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models.encoder import HybridEncoder as JHybridEncoder
from ide3d_tpu.models.encoder import MultiViewHybridEncoder as JMultiView
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu_torch.apps import converter_log_to_video, infer_face_animation, infer_hybrid_encoder
from ide3d_tpu_torch.apps import viz_renderer as viz
from ide3d_tpu_torch.apps.painter import PainterSession
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.encoder import HybridEncoder, MultiViewHybridEncoder
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator, Ide3dSynthesisNetwork
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
TYPES = ("image", "raw", "seg", "depth", "normals")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def bridged():
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, _np(params))
    return jG, params, G.eval()


@pytest.fixture(scope="module")
def renderers(bridged):
    jG, params, G = bridged
    return jviz.VizRenderer(jG, params), viz.VizRenderer(G)


def _levels(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


# ------------------------------------------------------------------ the renderer


@pytest.mark.parametrize("num_steps", [4, 48])
def test_render_types_match_jax(renderers, num_steps):
    """Every render type within 1 uint8 level, at the tiny preset's budget and
    at VizState's default 48 + 48. Normals: the weights_sum > 0.5 mask is
    compared pixel by pixel; a pixel whose sum lies within rounding of 0.5
    may flip, at most 0.1% of them (0 here: 64 pixels)."""
    jr, r = renderers
    for t in TYPES:
        st = viz.VizState(seed=1, yaw=0.2, pitch=-0.1, render_type=t, num_steps=num_steps)
        got, _ = r.render(st)
        want, _ = jr.render(jviz.VizState(**{k: getattr(st, k) for k in st.__dataclass_fields__}))
        assert got.dtype == np.uint8 and got.shape == want.shape, (t, got.shape, want.shape)
        if t == "normals":
            flips = int(((got.max(-1) == 0) != (want.max(-1) == 0)).sum())
            assert flips <= 0.001 * got.shape[0] * got.shape[1], flips
            keep = (got.max(-1) > 0) & (want.max(-1) > 0)
            assert _levels(got[keep], want[keep]) <= 1, t
        else:
            assert _levels(got, want) <= 1, t


def test_render_caches_planes_per_identity(bridged, monkeypatch):
    """generate_planes once per (seed, mix, psi, cutoff); one G pass a render,
    cached or not; a pose change hits the cache; noise_mode is not read."""
    _, _, G = bridged
    calls = {"planes": 0, "frames": 0}
    real_planes, real_fwd = Ide3dSynthesisNetwork.generate_planes, Ide3dSynthesisNetwork.forward

    def planes(self, *a, **kw):
        calls["planes"] += 1
        return real_planes(self, *a, **kw)

    def fwd(self, *a, **kw):
        calls["frames"] += 1
        assert kw.get("noise_mode", "const") == "const" and kw["table"] is not None
        return real_fwd(self, *a, **kw)

    monkeypatch.setattr(Ide3dSynthesisNetwork, "generate_planes", planes)
    monkeypatch.setattr(Ide3dSynthesisNetwork, "forward", fwd)
    r = viz.VizRenderer(G)
    states = [viz.VizState(seed=1, num_steps=4), viz.VizState(seed=1, yaw=0.3, num_steps=4),
              viz.VizState(seed=1, yaw=0.3, render_type="depth", num_steps=4),
              viz.VizState(seed=2, num_steps=4), viz.VizState(seed=2, truncation_psi=0.5, num_steps=4),
              viz.VizState(seed=2, truncation_psi=0.5, stylemix_seed=5, stylemix_geometry=True,
                           num_steps=4)]
    hits = [r.render(st)[1]["plane_cached"] for st in states]
    assert hits == [False, True, True, False, False, False]
    assert calls == {"planes": 4, "frames": 6}
    a, _ = r.render(viz.VizState(seed=3, num_steps=4, noise_mode="random"))
    b, _ = r.render(viz.VizState(seed=3, num_steps=4))
    assert np.array_equal(a, b)


def test_stylemix_matches_jax(renderers):
    """Geometry rows from one seed, appearance rows from another (the split
    at num_ws_geo), as the JAX renderer mixes them."""
    jr, r = renderers
    for geo, app in ((True, False), (False, True), (True, True)):
        kw = dict(seed=1, stylemix_seed=5, stylemix_geometry=geo, stylemix_appearance=app,
                  num_steps=4)
        got, _ = r.render(viz.VizState(**kw))
        want, _ = jr.render(jviz.VizState(**kw))
        assert _levels(got, want) <= 1, (geo, app)


def test_capture_layers_match_jax(renderers, bridged, monkeypatch):
    """The taps' names (in the JAX order), shapes, statistics and previews;
    one G pass."""
    jr, r = renderers
    st = viz.VizState(seed=4, yaw=-0.2, num_steps=4)
    want = jr.capture_layers(jviz.VizState(seed=4, yaw=-0.2, num_steps=4))
    got = r.capture_layers(st)
    assert sorted(got) == sorted(want)  # the JAX taps come back key-sorted (a jitted pytree)
    for name, w in want.items():
        g = got[name]
        assert g["shape"] == w["shape"], name
        assert abs(g["mean"] - w["mean"]) <= 1e-4 * (abs(w["mean"]) + w["std"]), name
        assert abs(g["std"] - w["std"]) <= 1e-4 * w["std"], name
        assert ("preview" in g) == ("preview" in w)
        if "preview" in w:
            assert g["preview"].shape == w["preview"].shape
            assert _levels(g["preview"], w["preview"]) <= 1, name


def test_server_routes_without_a_socket(renderers):
    _, r = renderers
    server = viz.VizServer(r)
    status, ctype, page, _ = server.handle("/", {})
    assert status == 200 and ctype == "text/html" and b"/render?" in page
    q = {"seed": "2", "yaw": "0.1", "pitch": "0", "trunc": "0.6", "type": "seg", "mix": "3",
         "mix_geo": "1", "mix_app": "0"}
    status, ctype, png, headers = server.handle("/render", q)
    assert status == 200 and ctype == "image/png" and float(headers["X-Render-Time"]) >= 0
    want, _ = r.render(viz.state_from_query(q))
    assert np.array_equal(np.asarray(PIL.Image.open(io.BytesIO(png))), want)
    st = viz.state_from_query(q)
    assert (st.seed, st.stylemix_seed, st.stylemix_geometry, st.stylemix_appearance,
            st.truncation_psi, st.render_type) == (2, 3, True, False, 0.6, "seg")
    assert server.handle("/nothing", {})[0] == 404


# ------------------------------------------------------------ the multi-view encoder


@pytest.mark.parametrize("views", [1, 3])
def test_multiview_encoder_matches_jax(views):
    """Each stream's pyramid on every view, the fusion on the JAX pyramid's
    own outputs, and the whole encoder. The fusion divides by a sum of signed
    sigmas over the views, so the whole encoder at V = 3 is held within
    1e-5 x max|output| x kappa, kappa = max|sigma| / min|sum of sigmas| (its
    condition number; 2.8e3 here, where the port reads 2.3e-3 of max|output|
    off the JAX package)."""
    jE = JMultiView(size=8, n_latents_app=2, n_latents_geo=3, w_dim=16, num_view=3)
    p = _np(jax.jit(jE.init)(jax.random.PRNGKey(0)))
    E = load_jax_params(MultiViewHybridEncoder(size=8, n_latents_app=2, n_latents_geo=3, w_dim=16,
                                               num_view=3), p).eval()
    rng = np.random.RandomState(views)
    img = rng.randn(views * 2, 8, 8, 3).astype(np.float32)
    seg = rng.randn(views * 2, 8, 8, 19).astype(np.float32)
    kappa = 1.0
    with torch.no_grad():
        for name, x, dim, nl in (("img", img, 3, 2), ("seg", seg, 19, 3)):
            jfeats = np.asarray(jax.jit(jE._stream(dim, nl)[0])(p[name]["pyramid"], jnp.asarray(x)))
            feats = getattr(E, name).pyramid(torch.from_numpy(x).permute(0, 3, 1, 2))
            err, scale = float(np.abs(feats.numpy() - jfeats).max()), float(np.abs(jfeats).max())
            assert err <= 1e-5 * scale, (name, err, scale)
            if views > 1:
                fused = E._fuse(torch.from_numpy(jfeats), 2).numpy()
                jfused = np.asarray(jax.jit(lambda f: jE._fuse(f, 2))(jnp.asarray(jfeats)))
                assert np.abs(fused - jfused).max() <= 1e-5 * np.abs(jfused).max(), name
                sigma = jfeats.reshape(views, 2, -1)[..., : jfeats.shape[-1] // 2]
                kappa = max(kappa, np.abs(sigma).max() / np.abs(sigma.sum(0)).min())
        got = E(torch.from_numpy(img), torch.from_numpy(seg), num_view=views)
    want = np.asarray(jax.jit(lambda p, i, s: jE(p, i, s, num_view=views))(
        p, jnp.asarray(img), jnp.asarray(seg)))
    assert got.shape == want.shape == (2, 5, 16)
    err, scale = float(np.abs(got.numpy() - want).max()), float(np.abs(want).max())
    assert err <= 1e-5 * scale * kappa, (err, scale, kappa)


def test_multiview_fusion_weights():
    """The features are fused by sigma / (sum over views), a zero sum read as 1e-4."""
    E = MultiViewHybridEncoder(size=8, n_latents_app=1, n_latents_geo=1, w_dim=4, num_view=2)
    feats = torch.tensor([[1.0, 0.0, 10.0, 20.0], [3.0, 0.0, 30.0, 40.0]])  # V=2, B=1, F=4
    fused = E._fuse(feats, 1)
    assert torch.allclose(fused, torch.tensor([[0.25 * 10 + 0.75 * 30, 0.0]]))


# ------------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def jax_encoder_tree(bridged):
    """The JAX CLIs' encoder, HybridEncoder.init(PRNGKey(0)) at G's width, as numpy."""
    G = bridged[2]
    n_geo = G.synthesis.num_ws_geo
    jE = JHybridEncoder(size=32, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo, w_dim=512)
    return _np(jax.jit(jE.init)(jax.random.PRNGKey(0)))


@pytest.fixture
def both_clis(bridged, jax_encoder_tree, monkeypatch):
    """Both packages' load_generator hand out the bridged G and their
    write_video capture the frames; the port's encoder is the JAX CLI's
    (HybridEncoder.init(PRNGKey(0)), bridged); the port's G passes are
    counted: returns ({"jax": [...], "port": [...]}, counts)."""
    jG, params, G = bridged
    written, counts = {"jax": [], "port": []}, {"frames": 0}
    monkeypatch.setattr(jcommon, "load_generator", lambda network: (jG, params))
    monkeypatch.setattr(tcommon, "load_generator", lambda network, device="cuda": G.to(device))

    def capture(key):
        def write_video(path, frames, fps=24):
            written[key].append([np.asarray(f) for f in frames])
            return path
        return write_video

    monkeypatch.setattr(jcommon, "write_video", capture("jax"))
    monkeypatch.setattr(tcommon, "write_video", capture("port"))
    n_geo = G.synthesis.num_ws_geo

    def build_encoder(G_, encoder, device):
        assert encoder == "random:0"
        E = HybridEncoder(size=32, n_latents_app=G_.num_ws - n_geo, n_latents_geo=n_geo, w_dim=512)
        return load_jax_params(E, jax_encoder_tree).to(device).eval().requires_grad_(False)

    monkeypatch.setattr(infer_hybrid_encoder, "build_encoder", build_encoder)
    real = Ide3dSynthesisNetwork.forward

    def fwd(self, *a, **kw):
        counts["frames"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(Ide3dSynthesisNetwork, "forward", fwd)
    return written, counts


def _write_masks(root, n, size=32, seed=0):
    os.makedirs(root)
    rs = np.random.RandomState(seed)
    for i in range(n):
        m = np.zeros((size, size), np.uint8)
        m[6:26, 8:24] = 1
        m[10:14, rs.randint(9, 12):rs.randint(20, 23)] = 4 + i % 3
        PIL.Image.fromarray(m).save(os.path.join(root, f"{i:04d}.png"))
    return root


def _frames_within_one_level(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert _levels(g, w) <= 1


@pytest.mark.parametrize("orbit", [False, True])
def test_face_animation_matches_jax(both_clis, tmp_path, orbit):
    """Each frame is an uncached Painter edit from the style latent: two G
    passes (K1 twice on the card)."""
    from ide3d_tpu.apps import infer_face_animation as janim

    written, counts = both_clis
    masks = _write_masks(str(tmp_path / "masks"), 3)
    argv = ["--network", "x", "--masks", masks, "--seed", "7", "--output", str(tmp_path / "a.mp4")]
    argv += ["--orbit"] if orbit else []
    janim.main(argv)
    infer_face_animation.main(argv + ["--device", "cpu"])
    assert counts["frames"] == 2 * 3
    _frames_within_one_level(written["port"][0], written["jax"][0])
    assert written["port"][0][0].shape == (32, 64, 3)


def test_log_replay_matches_jax(both_clis, bridged, tmp_path):
    """A session recorded by the port's PainterSession, replayed by both CLIs:
    the first entry an uncached edit (2 G passes), an entry at the same
    camera a stroke through the frame cache (1), a new camera 2."""
    from ide3d_tpu.apps import converter_log_to_video as jconv

    written, counts = both_clis
    _, _, G = bridged
    root = _write_masks(str(tmp_path / "m"), 3)
    masks = [np.asarray(PIL.Image.open(os.path.join(root, f))) for f in sorted(os.listdir(root))]
    sess = PainterSession(G=G, E=infer_hybrid_encoder.build_encoder(G, "random:0", "cpu"),
                          record=True, device="cpu")
    sess.set_seed(3)
    for mask, yaw in zip(masks, (0.0, 0.0, 0.25)):
        sess.edit(mask, yaw=yaw)
    log = str(tmp_path / "session.npz")
    sess.save_log(log)
    argv = ["--network", "x", "--log", log, "--seed", "3", "--output", str(tmp_path / "s.mp4")]
    jconv.main(argv)
    counts["frames"] = 0
    converter_log_to_video.main(argv + ["--device", "cpu"])
    assert counts["frames"] == 2 + 1 + 2
    _frames_within_one_level(written["port"][0], written["jax"][0])


def test_interactive_entry_points_reach_the_cpu_only_when_asked(monkeypatch, tmp_path):
    class _Stop(Exception):
        pass

    seen = []

    def fake_load(network, device="cuda"):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(tcommon, "load_generator", fake_load)
    runs = {
        infer_face_animation: ["--network", "x", "--masks", "m", "--output", "o.mp4"],
        converter_log_to_video: ["--network", "x", "--log", "l", "--output", "o.mp4"],
        viz: ["--network", "x"],
    }
    for mod, argv in runs.items():
        for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            with pytest.raises(_Stop):
                mod.main(argv + extra)
            assert seen.pop() == torch.device(want), mod.__name__
