"""The optional architectures behind the port's entry points, against the JAX
package on the CPU: the Painter session on a hybrid G, the viz renderer on a
hybrid G (which, as the JAX one, samples the planes alone), the avatar CLI on
an encoder G (from --style-image through G.encode, and the style-mix
fallback), cond_render's feature statistics, a NADA step on a hybrid G with
its feature volume frozen, and ResNetEncoder and its importer.

The tiny generators are initialised by JAX and bridged into the port through
io/from_jax.py. Float outputs within 2e-4 of max(1, max|ref|) (the golden
test's tolerance), uint8 frames within 1 level.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

import ide3d_tpu.apps.common as jcommon
from ide3d_tpu import render as jrender
from ide3d_tpu.apps import infer_face_animation_avatar as javatar
from ide3d_tpu.apps import painter as jpainter
from ide3d_tpu.apps import viz_renderer as jviz
from ide3d_tpu.metrics import features as jfeat
from ide3d_tpu.metrics.metric_utils import MetricOptions as JMetricOptions
from ide3d_tpu.metrics.metric_utils import compute_feature_stats_for_generator as jstats
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models.encoder import HybridEncoder as JHybridEncoder
from ide3d_tpu.models.resnet_encoder import ResNetEncoder as JResNetEncoder
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu_torch.apps import common, infer_face_animation_avatar, painter, viz_renderer
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.metrics.features import make_detector
from ide3d_tpu_torch.metrics.metric_utils import MetricOptions, compute_feature_stats_for_generator
from ide3d_tpu_torch.models.encoder import HybridEncoder
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.models.resnet_encoder import ResNetEncoder, import_resnet_encoder
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
from ide3d_tpu_torch.render.renderer import RenderParams
from ide3d_tpu_torch.train import nada
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
HYBRID = dict(use_feature_volume=True, fv_resolution=8, fv_base_channels=16)
ATOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(name, got, ref, tol=ATOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def _u8_close(name, got, ref):
    assert got.dtype == np.uint8 and got.shape == ref.shape, (name, got.shape, ref.shape)
    assert int(np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()) <= 1, name


def _bridge(extra):
    rp = dict(img_size=8, num_steps=4)
    jG = JGenerator(JGeneratorConfig(**TINY, **extra, render=JRenderParams(**rp)))
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, **extra, render=RenderParams(**rp)))
    load_jax_params(G, _np(params))
    return jG, params, G.eval()


@pytest.fixture(scope="module")
def hybrid():
    return _bridge(HYBRID)


@pytest.fixture(scope="module")
def encoder_g():
    return _bridge(dict(use_encoder=True))


# -------------------------------------------------------------- the Painter, viz


def test_painter_session_on_hybrid_g_matches_jax(hybrid):
    """set_seed, two views (the port's plane cache carries the volume; the JAX
    session renders a hybrid G uncached), a new-view edit and a stroke."""
    jG, g_params, G = hybrid
    n_geo = G.synthesis.num_ws_geo
    jE = JHybridEncoder(size=32, n_latents_app=jG.num_ws - n_geo, n_latents_geo=n_geo)
    e_params = jax.jit(jE.init)(jax.random.PRNGKey(1))
    E = load_jax_params(HybridEncoder(size=32, n_latents_app=G.num_ws - n_geo,
                                      n_latents_geo=n_geo), _np(e_params)).eval()
    js = jpainter.PainterSession(G=jG, E=jE, g_params=g_params, e_params=e_params)
    ts = painter.PainterSession(G=G, E=E, device="cpu")
    _close("set_seed w", ts.set_seed(3).numpy(), np.asarray(js.set_seed(3)))
    for yaw, pitch in ((0.3, -0.1), (-0.2, 0.0)):
        for name, got, ref in zip(("rgb", "seg"), ts.view(yaw, pitch), js.view(yaw, pitch)):
            _u8_close(f"view {yaw} {name}", got, ref)
    assert ts._table[1] is not None  # the cache holds the volume
    mask = np.random.RandomState(0).randint(0, 19, (32, 32)).astype(np.uint8)
    for yaw in (0.1, 0.1):  # a new view, then a stroke at that view
        for name, got, ref in zip(("rgb", "seg"), ts.edit(mask, yaw), js.edit(mask, yaw)):
            _u8_close(f"edit {yaw} {name}", got, ref)
        _close("edit w", ts.w.numpy(), np.asarray(js.w))
        mask = np.random.RandomState(1).randint(0, 19, (32, 32)).astype(np.uint8)


def test_viz_renderer_on_hybrid_g_samples_planes_alone_as_jax(hybrid):
    """The JAX viz renderer's table path renders a hybrid G without its
    volume; the port's does the same (within 1 uint8 level)."""
    jG, params, G = hybrid
    st = viz_renderer.VizState(seed=1, yaw=0.2, pitch=-0.1, render_type="image", num_steps=4)
    got, _ = viz_renderer.VizRenderer(G).render(st)
    want, _ = jviz.VizRenderer(jG, params).render(
        jviz.VizState(**{k: getattr(st, k) for k in st.__dataclass_fields__}))
    _u8_close("viz image", got, want)


# ------------------------------------------------------------------ the avatar


@pytest.mark.parametrize("style_image", [True, False], ids=["style_image", "style_mix"])
def test_avatar_cli_matches_jax(encoder_g, style_image, tmp_path, monkeypatch):
    """Both CLIs on the bridged encoder G, 3 frames: from --style-image
    through G.encode, and without it the appearance rows of --style-seed."""
    jG, params, G = encoder_g
    frames = {}

    def capture(key):
        def write_video(path, fr, fps=24):
            frames[key] = [np.asarray(f) for f in fr]
            return path
        return write_video

    monkeypatch.setattr(jcommon, "load_generator", lambda network: (jG, params))
    monkeypatch.setattr(jcommon, "write_video", capture("jax"))
    monkeypatch.setattr(common, "load_generator", lambda network, device="cuda": G.to(device))
    monkeypatch.setattr(common, "write_video", capture("port"))
    args = ["--network", "x", "--seed", "1", "--style-seed", "4", "--frames", "3"]
    if style_image:
        img = np.random.RandomState(5).randint(0, 255, (40, 40, 3), np.uint8)
        PIL.Image.fromarray(img).save(tmp_path / "style.png")
        args += ["--style-image", str(tmp_path / "style.png")]
    javatar.main(args + ["--output", str(tmp_path / "jax.mp4")])
    infer_face_animation_avatar.main(args + ["--output", str(tmp_path / "port.mp4"),
                                             "--device", "cpu"])
    assert len(frames["port"]) == len(frames["jax"]) == 3
    for i, (got, want) in enumerate(zip(frames["port"], frames["jax"])):
        _u8_close(f"frame {i}", got, want)
    assert not np.array_equal(frames["port"][0], frames["port"][1])


def test_avatar_cli_reaches_the_cpu_only_when_asked(monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def fake_load(network, device="cuda"):
        seen.append(torch.device(device))
        raise Stop

    monkeypatch.setattr(common, "load_generator", fake_load)
    for argv, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
        with pytest.raises(Stop):
            infer_face_animation_avatar.main(["--network", "random:0:tiny", "--output", "x.mp4",
                                              *argv])
        assert seen.pop() == torch.device(want)


# ----------------------------------------------------------------- cond_render


class FakeDataset:
    """(img uint8 HWC, label) items like data.ImageFolderDataset (the JAX
    package's tests/test_metrics.py FakeDataset)."""

    label_dim = 25

    def __init__(self, n=8, res=32):
        rng = np.random.RandomState(0)
        self.imgs = rng.randint(0, 255, (n, res, res, 3), np.uint8)
        self.labels = np.broadcast_to(np.asarray(CANONICAL_POSE_25, np.float32), (n, 25)).copy()

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], self.labels[i]

    def get_label(self, i):
        return self.labels[i]


def test_cond_render_feature_stats_match_jax(encoder_g):
    """The generator statistics of G(z, c, cond_img=<dataset image>) with the
    pixel detector: the same z, c and image draws from RandomState(seed) in
    both packages, mean and covariance within 2e-4 of their scale."""
    jG, params, G = encoder_g
    ds = FakeDataset()
    jopts = JMetricOptions(G=jG, g_params=params, dataset=ds, detector=jfeat.PixelFeatures(),
                           detector_params={}, num_items=4, batch_size=2, cond_render=True)
    opts = MetricOptions(G=G, dataset=ds, detector=make_detector("pixel", device="cpu"),
                         num_items=4, batch_size=2, cond_render=True, device="cpu")
    jmu, jcov = jstats(jopts).get_mean_cov()
    mu, cov = compute_feature_stats_for_generator(opts).get_mean_cov()
    _close("cond_render mean", mu, jmu)
    _close("cond_render cov", cov, jcov)
    plain = MetricOptions(G=G, dataset=ds, detector=opts.detector, num_items=4, batch_size=2,
                          device="cpu")
    assert not np.allclose(compute_feature_stats_for_generator(plain).get_mean_cov()[0], mu)


# ------------------------------------------------------------------------ NADA


@torch.enable_grad()  # some JAX test modules turn autograd off when imported
def test_nada_step_on_hybrid_g_freezes_the_volume(hybrid):
    """With geometry frozen the feature volume is out of the optimizer and
    bit-identical after a step, while the superres moves; trained, it gets a
    gradient (the volume shapes the render)."""
    _, _, G = hybrid
    proj = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))

    def embed(img):
        return img.mean(dim=(1, 2)) @ proj

    tdir = torch.randn(8, generator=torch.Generator().manual_seed(1))
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(2))
    c = torch.from_numpy(np.stack([CANONICAL_POSE_25] * 2))
    for freeze in (True, False):
        cfg = nada.NadaConfig(freeze_geometry=freeze)
        G_train = nada.init_nada(G, cfg)
        names = {n for n, _ in nada.nada_parameters(G_train, freeze)}
        assert any(n.startswith("feature_volume") for n in names) is not freeze
        before = {k: v.clone() for k, v in G_train.state_dict().items()}
        fv = G_train.synthesis.feature_volume
        loss = nada.nada_loss(G_train, G, embed, tdir / tdir.norm(), z, c,
                              torch.Generator().manual_seed(3))
        grads = torch.autograd.grad(loss, [p for p in fv.parameters() if p.requires_grad]
                                    or [G_train.synthesis.b32.torgb.weight], allow_unused=True)
        if freeze:
            assert not any(p.requires_grad for p in fv.parameters())
        else:
            assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0
        step = nada.make_nada_step(G_train, G, embed, tdir, cfg)
        assert np.isfinite(float(step(z, c, torch.Generator().manual_seed(3))))
        after = G_train.state_dict()
        moved = {k for k in after if not torch.equal(after[k], before[k])}
        assert any(k.startswith("synthesis.b32") for k in moved)
        assert any(k.startswith("synthesis.feature_volume") for k in moved) is not freeze


# --------------------------------------------------------------- ResNetEncoder


@pytest.mark.parametrize("size", [48, 240])
def test_resnet_encoder_matches_jax(size):
    """The pooled features of the JAX package's seeded init on a 48² input
    (bicubic up to 224²) and a 240² one (antialiased down), within 1e-4 of
    their scale (Keys' cubic in both; conv sums in another order)."""
    x = np.random.RandomState(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jE = JResNetEncoder()
    want = np.asarray(jax.jit(jE.__call__)(jE.init(None), jnp.asarray(x)))
    with torch.no_grad():
        got = ResNetEncoder().init()(torch.from_numpy(x))
    assert got.shape == (2, 512)
    _close(f"ResNetEncoder {size}", got.numpy(), want, 1e-4)


def test_import_resnet_encoder_reads_a_torchvision_file(tmp_path):
    """A torchvision-named state dict with its fc head and BN counters, read
    by the stub reader: the trunk's tensors exactly; a missing one raises."""
    ref = ResNetEncoder().init()
    for p in ref.parameters():
        p.data.add_(0.01)
    sd = dict(ref.state_dict(), **{"fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000),
                                   "bn1.num_batches_tracked": torch.tensor(5)})
    torch.save(sd, tmp_path / "r18.pth")
    enc = import_resnet_encoder(str(tmp_path / "r18.pth"), device="cpu")
    got = enc.state_dict()
    assert sorted(got) == sorted(ref.state_dict()) and not enc.training
    assert all(torch.equal(got[k], ref.state_dict()[k]) for k in got)
    del sd["layer4.1.bn2.running_var"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="layer4.1.bn2.running_var"):
        import_resnet_encoder(str(tmp_path / "short.pth"), device="cpu")


def test_new_modules_leave_jax_out():
    code = ("import sys, ide3d_tpu_torch.apps.infer_face_animation_avatar, "
            "ide3d_tpu_torch.models.resnet_encoder, ide3d_tpu_torch.models.generator, "
            "ide3d_tpu_torch.models.layers_sg3, ide3d_tpu_torch.ops.filtered_lrelu; "
            "print('jax' in sys.modules, 'ide3d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False False"
