"""The port's metric suite against the JAX package's, on the CPU, fp32.

The detectors (pixel, VGG16/VGG19, InceptionV3) and LPIPS take JAX parameter
trees bridged with io/from_jax.load_jax_params; the tiny G of
tests/test_metrics.py is initialised by JAX and bridged the same way. Inputs
are numpy draws from a seed; every tolerance is stated beside its check.
Also: the resize filter against jax.image.resize, a torchvision-named .pth
read by both make_detectors, the FID/KID/PR/IS arithmetic and FeatureStats
on the same features, RenderParams.pixel_offset through the render,
ImageFolderDataset.__getitem__, and the calc_metrics / train_gan --metrics
CLI at the tiny preset (train_gan --metrics: tests/test_torch_train_step.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ide3d_tpu.data.dataset import ImageFolderDataset as JImageFolderDataset
from ide3d_tpu.metrics import calc_metric as j_calc_metric
from ide3d_tpu.metrics import features as jfeat
from ide3d_tpu.metrics import frechet_inception_distance as jfid
from ide3d_tpu.metrics import inception_score as jis
from ide3d_tpu.metrics import kernel_inception_distance as jkid
from ide3d_tpu.metrics import list_metrics as j_list_metrics
from ide3d_tpu.metrics import precision_recall as jpr
from ide3d_tpu.metrics.lpips import LPIPS as JLPIPS
from ide3d_tpu.metrics.metric_utils import FeatureStats as JFeatureStats
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.render.renderer import TriplaneRenderer as JRenderer
from ide3d_tpu_torch.apps import calc_metrics
from ide3d_tpu_torch.apps.common import load_generator
from ide3d_tpu_torch.data.dataset import ImageFolderDataset
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.metrics import calc_metric, features, list_metrics, make_detector
from ide3d_tpu_torch.metrics import frechet_inception_distance as tfid
from ide3d_tpu_torch.metrics import inception_score as tis
from ide3d_tpu_torch.metrics import kernel_inception_distance as tkid
from ide3d_tpu_torch.metrics import precision_recall as tpr
from ide3d_tpu_torch.metrics.lpips import LPIPS
from ide3d_tpu_torch.metrics.metric_utils import FeatureStats
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
from ide3d_tpu_torch.render.renderer import RenderParams, TriplaneRenderer
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _finite_close(got, want, rtol=0.0, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _images(seed, shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


# ----------------------------------------------------------------- the detectors


@pytest.mark.parametrize("hw,size,ch", [(512, 299, 3), (512, 224, 3), (14, 7, 16), (64, 32, 1)])
def test_resize_matches_jax_image_resize(hw, size, ch):
    """The detectors' resize (antialiased bilinear) against jax.image.resize
    "linear" at the four sizes the detectors use: fp32, <= 1e-5 abs."""
    x = _images(0, (2, hw, hw, ch))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, size, size, ch), "linear"))
    got = features.resize(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape
    _finite_close(got, want, atol=1e-5)


def test_pixel_features_match_jax():
    """PixelFeatures at 64² -> 32² gray: <= 1e-6 abs."""
    x = _images(1, (3, 64, 64, 3))
    want = np.asarray(jfeat.PixelFeatures()({}, jnp.asarray(x)))
    got = features.PixelFeatures()(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 1024)
    _finite_close(got, want, atol=1e-6)


# fc1's width: the JAX __call__ takes it from the tree, and a narrow fc1 keeps
# the trees and the bridge cheap (the full 25088 x 4096 fc1 is 1e8 values).
FC_DIM = 256


@pytest.fixture(scope="module")
def vgg16_tree():
    return _vgg_tree("vgg16", 0)


def _vgg_tree(cfg_name, seed):
    """A JAX VGG tree from a seed, He-scaled so activations stay O(1..100)."""
    rng = np.random.default_rng(seed)
    cfg = jfeat._VGG19_CFG if cfg_name == "vgg19" else jfeat._VGG16_CFG
    tree, in_ch, idx = {"features": {}, "classifier": {}}, 3, 0
    for v in cfg:
        if v == "M":
            idx += 1
            continue
        tree["features"][str(idx)] = {
            "weight": rng.standard_normal((3, 3, in_ch, v), np.float32) * np.float32(np.sqrt(2 / (9 * in_ch))),
            "bias": rng.standard_normal(v, np.float32) * np.float32(0.1)}
        in_ch, idx = v, idx + 2
    tree["classifier"]["0"] = {
        "weight": rng.standard_normal((512 * 7 * 7, FC_DIM), np.float32) * np.float32(0.01),
        "bias": rng.standard_normal(FC_DIM, np.float32) * np.float32(0.1)}
    return tree


@pytest.mark.parametrize("cfg_name", ["vgg16", "vgg19"])
def test_vgg_features_match_jax(cfg_name, vgg16_tree):
    """VGG16Features (taps at 32², fc1 at 224² from a 40² input, NCHW flatten
    order) with bridged weights: each tap and fc1 within 1e-5 x max|value|
    (fp32 convs, only the sums' order differs)."""
    tree = vgg16_tree if cfg_name == "vgg16" else _vgg_tree("vgg19", 1)
    jdet = jfeat.VGG16Features(cfg_name=cfg_name)
    det = load_jax_params(features.VGG16Features(FC_DIM, cfg_name), tree).eval()
    x_taps, x_fc = _images(2, (1, 32, 32, 3)), _images(3, (1, 40, 40, 3))
    want_taps = jax.jit(jdet.feature_maps)(tree, jnp.asarray(x_taps))
    want_fc = np.asarray(jax.jit(jdet.__call__)(tree, jnp.asarray(x_fc)))
    with torch.inference_mode():
        got_taps = det.feature_maps(torch.from_numpy(x_taps))
        got_fc = det(torch.from_numpy(x_fc)).numpy()
    assert len(got_taps) == len(want_taps) == 5
    for g, w in zip(got_taps, want_taps):
        assert tuple(g.shape) == w.shape
        assert _rel_err(g.numpy(), w) <= 1e-5
    assert got_fc.shape == (1, FC_DIM)
    assert _rel_err(got_fc, want_fc) <= 1e-5


@pytest.fixture(scope="module")
def inception_tree():
    return _np(jfeat.InceptionV3().init())


_j_inception = jax.jit(lambda p, x: jfeat.InceptionV3()(p, x))  # one trace for both tests


def test_inception_matches_jax(inception_tree):
    """InceptionV3 at batch 2, 299², JAX init() weights bridged: the port's own
    init() gives the same tensors exactly, and the features agree within
    1e-5 x max|feature| (the deterministic init shrinks the features to ~1e-6,
    so the tolerance is relative)."""
    det = load_jax_params(features.InceptionV3(), inception_tree).eval()
    own = features.InceptionV3().init().state_dict()
    for k, v in det.state_dict().items():
        assert torch.equal(v, own[k]), k
    x = _images(4, (2, 299, 299, 3))
    want = np.asarray(_j_inception(inception_tree, jnp.asarray(x)))
    with torch.inference_mode():
        got = det(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    assert _rel_err(got, want) <= 1e-5


def test_lpips_matches_jax(vgg16_tree):
    """LPIPS at 64², the JAX tree (`vgg` + lin0..lin4 of shape (C,)) bridged as
    it is: distances within 1e-5 relative."""
    rng = np.random.default_rng(5)
    tree = {"vgg": vgg16_tree}
    for i, c in enumerate((64, 128, 256, 512, 512)):
        tree[f"lin{i}"] = {"weight": np.abs(rng.standard_normal(c, np.float32)) * np.float32(0.1)}
    lp = LPIPS()
    lp.vgg = features.VGG16Features(FC_DIM)  # LPIPS reads no fc1; the narrow one bridges cheaply
    lp = load_jax_params(lp, tree).eval()
    x, y = _images(6, (2, 64, 64, 3)), _images(7, (2, 64, 64, 3))
    want = np.asarray(jax.jit(JLPIPS().__call__)(tree, jnp.asarray(x), jnp.asarray(y)))
    with torch.inference_mode():
        got = lp(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        same = lp.mean(torch.from_numpy(x), torch.from_numpy(x)).item()
    assert got.shape == (2,) and same == 0.0
    _finite_close(got, want, rtol=1e-5)


def test_torchvision_weights_file_reads_the_same_in_both(tmp_path, inception_tree):
    """A torchvision-named Inception .pth (BN running stats that matter,
    `num_batches_tracked`, an unused `fc` head) written from the port's
    detector: both make_detectors read it to the same features (1e-5 x
    max|feature|) and stamp `torch-weights`; a file that lacks a tensor raises."""
    det = load_jax_params(features.InceptionV3(), inception_tree)
    rng = np.random.default_rng(8)
    sd = {}
    for k, v in det.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.from_numpy(rng.standard_normal(v.shape, np.float32)) * 1e-2
        elif k.endswith("running_var"):
            v = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        sd[k] = v
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    path = str(tmp_path / "inception.pth")
    torch.save(sd, path)

    tdet = make_detector("inception", path, device="cpu")
    jdet, jparams = jfeat.make_detector("inception", path)
    assert tdet.provenance == jdet.provenance
    assert tdet.provenance["source"] == "torch-weights"
    assert isinstance(jdet, jfeat.InceptionV3)
    x = _images(9, (2, 299, 299, 3))
    want = np.asarray(_j_inception(jparams, jnp.asarray(x)))
    with torch.inference_mode():
        got = tdet(torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) <= 1e-5

    del sd["Mixed_7c.branch_pool.bn.running_var"]
    torch.save(sd, path)
    with pytest.raises(KeyError):
        make_detector("inception", path, device="cpu")


def test_make_detector_factory_and_provenance():
    """Name dispatch, provenance stamps as in JAX (tests/test_metrics.py), eval
    mode, typos raise."""
    det = make_detector("pixel", device="cpu")
    assert isinstance(det, features.PixelFeatures) and not det.training
    assert det.provenance == jfeat.make_detector("pixel")[0].provenance
    det = make_detector("inception", device="cpu")
    assert isinstance(det, features.InceptionV3) and not det.training
    assert det.provenance == {"detector": "inception", "weights": None,
                              "source": "random-init(deterministic)"}
    with pytest.raises(ValueError):
        make_detector("vgg", device="cpu")


# ---------------------------------------------------------- the numpy arithmetic


def test_feature_stats_and_arithmetic_match_jax(monkeypatch):
    """FeatureStats (appended in ragged batches, capped) and the FID, KID, PR
    and IS of the same numpy features, the port's compute_* against the JAX
    package's with the stats handed in: <= 1e-10 relative, PR exact."""
    rs = np.random.RandomState(0)
    real = rs.randn(160, 12).astype(np.float32)
    gen = (rs.randn(150, 12) * 1.3 + 0.4).astype(np.float32)

    def banks(cls, feats, cap):
        st = cls(capture_all=True, capture_mean_cov=True, max_items=cap)
        for i in range(0, len(feats), 48):
            st.append(feats[i:i + 48])
        return st

    t_real, j_real = banks(FeatureStats, real, 128), banks(JFeatureStats, real, 128)
    t_gen, j_gen = banks(FeatureStats, gen, None), banks(JFeatureStats, gen, None)
    assert t_real.num_items == j_real.num_items == 128
    for a, b in ((t_real, j_real), (t_gen, j_gen)):
        np.testing.assert_array_equal(a.get_all(), b.get_all())
        for x, y in zip(a.get_mean_cov(), b.get_mean_cov()):
            np.testing.assert_array_equal(x, y)

    def patch(mod, real_st, gen_st):
        monkeypatch.setattr(mod, "compute_feature_stats_for_dataset", lambda opts, **kw: real_st,
                            raising=False)  # IS reads no dataset
        monkeypatch.setattr(mod, "compute_feature_stats_for_generator", lambda opts, **kw: gen_st)

    class Opts:
        seed = 3

    for mod, st in ((tfid, (t_real, t_gen)), (tkid, (t_real, t_gen)), (tpr, (t_real, t_gen)),
                    (tis, (t_real, t_gen)), (jfid, (j_real, j_gen)), (jkid, (j_real, j_gen)),
                    (jpr, (j_real, j_gen)), (jis, (j_real, j_gen))):
        patch(mod, *st)
    _finite_close(tfid.compute_fid(Opts), jfid.compute_fid(Opts), rtol=1e-10)
    _finite_close(tkid.compute_kid(Opts), jkid.compute_kid(Opts), rtol=1e-10)
    assert tpr.compute_pr(Opts) == jpr.compute_pr(Opts)
    _finite_close(tis.compute_is(Opts), jis.compute_is(Opts), rtol=1e-10)


def test_feature_stats_cache_round_trip(tmp_path):
    st = FeatureStats(capture_all=True, capture_mean_cov=True)
    st.append(np.random.RandomState(0).randn(10, 4))
    path = str(tmp_path / "st.pkl")
    st.save(path)
    back = FeatureStats.load(path)
    np.testing.assert_array_equal(back.get_all(), st.get_all())
    assert back.num_items == 10


# ------------------------------------------------------------ the whole metrics


class FakeDataset:
    """Indexable (img uint8 HWC, label) like data.ImageFolderDataset (as the
    JAX package's tests/test_metrics.py)."""

    label_dim = 25
    _path = "fake"

    def __init__(self, n=16, res=32, seed=0):
        rng = np.random.RandomState(seed)
        self.imgs = rng.randint(0, 255, (n, res, res, 3), np.uint8)
        self.labels = np.broadcast_to(np.asarray(CANONICAL_POSE_25, np.float32), (n, 25)).copy()

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.imgs[i], self.labels[i]

    def get_label(self, i):
        return self.labels[i]


@pytest.fixture(scope="module")
def bridged():
    """(JAX G, its params from PRNGKey(0), the port's G with the same weights)."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, _np(params))
    return jG, params, G.eval()


def test_metric_registry_matches_jax():
    """The same names (every reference preset), plus `is` for inception_score."""
    assert set(list_metrics()) == set(j_list_metrics()) | {"is"}


# metric, its JAX name, calc_metric kwargs, {result key: (rtol, atol)}. Readings
# (CPU, fp32): FID 8.1e-7, KID 3.5e-6, IS 7.3e-7 relative; PR equal; EQ-T
# 7.6e-6 dB, EQ-R 5.5e-6 dB; PPL 2.0e-2 relative (the random render draws
# differ between the packages, see the test).
METRIC_CASES = [
    ("fid", "fid", {"num_items": 16, "batch_size": 8}, {"fid": (1e-5, 0)}),
    ("kid", "kid", {"num_items": 16, "batch_size": 8}, {"kid": (2e-5, 0)}),
    ("pr", "pr", {"num_items": 16, "batch_size": 8}, {"precision": (0, 0), "recall": (0, 0)}),
    ("is", "inception_score", {"num_items": 16, "batch_size": 8},
     {"is_mean": (1e-5, 0), "is_std": (1e-5, 0)}),
    ("ppl2_wend", "ppl2_wend", {"num_items": 8, "batch_size": 4}, {"ppl2_wend": (5e-2, 0)}),
    ("eqt", "eqt", {"num_items": 2, "batch_size": 1}, {"eqt_psnr_db": (0, 1e-4)}),
    ("eqr", "eqr", {"num_items": 2, "batch_size": 1}, {"eqr_psnr_db": (0, 1e-4)}),
]


# One JAX detector object for every case: the JAX package keeps one jitted
# G + detector program per (G, detector) pair, so fid, kid, pr and is share it.
J_PIXEL = jfeat.make_detector("pixel")[0]


@pytest.mark.parametrize("name,jname,kw,tols", METRIC_CASES, ids=[c[0] for c in METRIC_CASES])
def test_calc_metric_matches_jax(name, jname, kw, tols, bridged, tmp_path):
    """calc_metric end to end on the bridged tiny G, the pixel detector and a
    FakeDataset (the same z, c and t draws from RandomState(seed) in both),
    against the JAX record. PPL renders with noise_mode='random': the layer
    noise strengths are 0 at init, so the noise draw cancels here and this is
    no test of it; the renderer's depth jitter and importance draws do not
    cancel, and the two packages draw them from different generators (the
    pair shares its draws in each), hence PPL's looser rtol."""
    jG, params, G = bridged
    ds = FakeDataset()
    rec = calc_metric(name, run_dir=str(tmp_path), G=G, dataset=ds,
                      detector=make_detector("pixel", device="cpu"), device="cpu", **kw)
    jrec = j_calc_metric(jname, G=jG, g_params=params, dataset=ds, detector=J_PIXEL,
                         detector_params={}, **kw)
    assert set(rec["results"]) == set(jrec["results"]) == set(tols)
    for key, (rtol, atol) in tols.items():
        _finite_close(rec["results"][key], jrec["results"][key], rtol=rtol, atol=atol)
    assert rec["detector"] == jrec["detector"] and rec["num_items"] == jrec["num_items"]
    line = json.loads((tmp_path / f"metric-{name}.jsonl").read_text().splitlines()[-1])
    assert line["metric"] == name and line["results"] == rec["results"]


def test_dataset_stats_are_cached_by_dataset_identity(bridged, tmp_path):
    """The real statistics' cache: a second call reads the file; another
    dataset of the same basename but another length gets another entry."""
    from ide3d_tpu_torch.metrics.metric_utils import (
        MetricOptions, _cache_path, compute_feature_stats_for_dataset)

    det = make_detector("pixel", device="cpu")
    opts = MetricOptions(dataset=FakeDataset(n=8), detector=det, num_items=8, batch_size=4,
                         cache_dir=str(tmp_path), device="cpu")
    other = MetricOptions(dataset=FakeDataset(n=16, seed=1), detector=det, num_items=8,
                          batch_size=4, cache_dir=str(tmp_path), device="cpu")
    path = _cache_path(opts, "dataset", False, True)
    assert path != _cache_path(other, "dataset", False, True)
    mu, _ = compute_feature_stats_for_dataset(opts).get_mean_cov()
    assert os.path.exists(path)
    mu2, _ = compute_feature_stats_for_dataset(opts).get_mean_cov()
    np.testing.assert_array_equal(mu, mu2)
    mu3, _ = compute_feature_stats_for_dataset(other).get_mean_cov()
    assert not np.allclose(mu, mu3)


def test_dataset_stats_are_cached_by_detector_weights(tmp_path):
    """One detector class under the random init and under two weights files:
    three cache entries for one dataset, so a run with real weights never
    reads the statistics of the random init."""
    from ide3d_tpu_torch.metrics.metric_utils import MetricOptions, _cache_path

    dets = [make_detector("inception", device="cpu")]
    files = [str(tmp_path / f"inception{i}.pth") for i in range(2)]
    for f in files:
        torch.save(dets[0].state_dict(), f)
    dets += [make_detector("inception", f, device="cpu") for f in files]
    paths = {_cache_path(MetricOptions(dataset=FakeDataset(n=8), detector=d, num_items=8,
                                       cache_dir=str(tmp_path), device="cpu"),
                         "dataset", False, True) for d in dets}
    assert len(paths) == 3


def test_cond_render_raises(bridged):
    """cond_render needs a dataset and a G with the built-in encoder, as the
    JAX package asserts (tests/test_torch_arch_apps.py holds it against JAX)."""
    from ide3d_tpu_torch.metrics.metric_utils import MetricOptions, \
        compute_feature_stats_for_generator

    det = make_detector("pixel", device="cpu")
    opts = MetricOptions(G=bridged[2], detector=det, num_items=2, batch_size=2,
                         cond_render=True, device="cpu")
    with pytest.raises(ValueError, match="needs a dataset"):
        compute_feature_stats_for_generator(opts)
    opts.dataset = FakeDataset(n=4)
    with pytest.raises(ValueError, match="use_encoder"):
        compute_feature_stats_for_generator(opts)


# ------------------------------------------------------ render and dataset pieces


def test_pixel_offset_through_render_matches_jax():
    """RenderParams.pixel_offset shifts the rays of the coarse pass and, through
    its origins and directions, the fine pass: the deterministic render of
    random planes against the JAX renderer's, <= 1e-5 abs; and it moves the
    image (the offset is not dropped)."""
    rng = np.random.RandomState(10)
    C = 8
    img_v = rng.randn(1, 16, 16, 3 * C).astype(np.float32)
    seg_v = rng.randn(1, 16, 16, 3 * 19).astype(np.float32)
    jr = JRenderer(feature_channels=C)
    jparams = _np(jr.init(jax.random.PRNGKey(1)))
    tr = TriplaneRenderer(feature_channels=C)
    load_jax_params(tr, jparams)
    c2w = np.asarray(CANONICAL_POSE_25, np.float32)[:16].reshape(1, 4, 4)
    outs = []
    for off in ((0.0, 0.0), (0.3, -0.1)):
        jrp = JRenderParams(img_size=8, num_steps=6, pixel_offset=off)
        trp = RenderParams(img_size=8, num_steps=6, pixel_offset=off)
        want = jax.jit(lambda p, a, b, c: jr.render(p, a, b, c, jrp))(
            jparams, jnp.asarray(img_v), jnp.asarray(seg_v), jnp.asarray(c2w))
        with torch.inference_mode():
            got = tr.render_fine(tr.render_coarse(torch.from_numpy(img_v), torch.from_numpy(seg_v),
                                                  torch.from_numpy(c2w), trp), trp)
        for k in ("feature", "seg", "depth", "weights_sum"):
            _finite_close(got[k].numpy(), np.asarray(want[k]), atol=1e-5)
        outs.append(got["feature"].numpy())
    assert np.abs(outs[0] - outs[1]).max() > 1e-2


def _write_folder(root, n, R, labels=True):
    imgs, segs = os.path.join(root, "imgs"), os.path.join(root, "segs")
    os.makedirs(imgs)
    os.makedirs(segs)
    rng = np.random.RandomState(11)
    lab = {}
    for i in range(n):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(os.path.join(imgs, name))
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(os.path.join(segs, name))
        lab[name] = rng.randn(25).tolist()
    if labels:
        with open(os.path.join(imgs, "dataset.json"), "w") as f:
            json.dump({"labels": list(lab.items())}, f)
    return imgs, segs


def test_image_folder_getitem_matches_jax(tmp_path):
    """__getitem__ with and without seg, xflip copies relabeled: equal to JAX's;
    get_label(i) is the item's label."""
    imgs, segs = _write_folder(str(tmp_path), 3, 16)
    for kw in ({}, {"seg_path": segs, "load_seg": True}):
        ours = ImageFolderDataset(imgs, xflip=True, **kw)
        theirs = JImageFolderDataset(imgs, xflip=True, **kw)
        assert len(ours) == len(theirs) == 6
        for i in range(6):
            a, b = ours[i], theirs[i]
            assert len(a) == len(b) == (3 if kw else 2)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(ours.get_label(i), b[-1])
        assert not np.array_equal(ours[0][-1], ours[3][-1])  # the mirror's label


# ---------------------------------------------------------------------- the CLIs


def test_calc_metrics_cli_writes_records(tmp_path):
    """calc_metrics at random:0:tiny on the CPU, on a folder of 8 images: one
    finite record per metric, printed and appended to --run-dir."""
    imgs, _ = _write_folder(str(tmp_path), 8, 32)
    run = str(tmp_path / "run")
    recs = calc_metrics.main(["--network", "random:0:tiny", "--data", imgs, "--metrics",
                              "fid,eqt", "--num-items", "8", "--batch", "4", "--device", "cpu",
                              "--cache-dir", str(tmp_path / "cache"), "--run-dir", run])
    assert [r["metric"] for r in recs] == ["fid", "eqt"]
    assert np.isfinite(recs[0]["results"]["fid"]) and np.isfinite(recs[1]["results"]["eqt_psnr_db"])
    for name in ("fid", "eqt"):
        line = json.loads(open(os.path.join(run, f"metric-{name}.jsonl")).read().splitlines()[-1])
        assert line["detector"]["source"] == "weightless-pixel"


def test_load_generator_unknown_preset_raises():
    with pytest.raises(ValueError, match="nosuch"):
        load_generator("random:0:nosuch", "cpu")

