"""The port's offline-generation CLIs against the JAX package's, on the CPU:
gen_videos, extract_shapes, render_mesh, avg_spectra, utils/marching and
snapshot loading.

One tiny G is initialised by JAX and bridged into the port (io/from_jax.py).
Both packages' `apps.common.load_generator` are monkeypatched to hand it out
and their `write_video` to capture the frames, so each CLI runs as a user
calls it, through its own main."""

import inspect
import os
import subprocess
import sys

import jax
import numpy as np
import PIL.Image
import pytest
import torch

import ide3d_tpu.apps.common as jcommon
import ide3d_tpu_torch.apps.common as tcommon
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.utils import marching as jmarching
from ide3d_tpu_torch.apps import avg_spectra, extract_shapes, gen_videos, render_mesh
from ide3d_tpu_torch.io import torch_import
from ide3d_tpu_torch.io.checkpoint import save_checkpoint
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.parallel import mesh
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
from ide3d_tpu_torch.render.renderer import RenderParams
from ide3d_tpu_torch.utils import marching as tmarching
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")


@pytest.fixture(scope="module")
def bridged():
    """(JAX G, its params from PRNGKey(0), the port's G with the same weights)."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, params))
    return jG, params, G.eval()


@pytest.fixture
def both_clis(bridged, monkeypatch):
    """Both packages' load_generator hand out the bridged G; their write_video
    captures the frames: returns {"jax": [...], "port": [...]} of frame lists."""
    jG, params, G = bridged
    written = {"jax": [], "port": []}
    monkeypatch.setattr(jcommon, "load_generator", lambda network: (jG, params))
    monkeypatch.setattr(tcommon, "load_generator", lambda network, device="cuda": G.to(device))

    def capture(key):
        def write_video(path, frames, fps=24):
            written[key].append([np.asarray(f) for f in frames])
            return path
        return write_video

    monkeypatch.setattr(jcommon, "write_video", capture("jax"))
    monkeypatch.setattr(tcommon, "write_video", capture("port"))
    return written


def _frames_within_one_level(got, want):
    assert len(got) == len(want) and len(got) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape, (g.shape, w.shape)
        assert int(np.abs(g.astype(np.int32) - w.astype(np.int32)).max()) <= 1


def _sigma_close(got, want):
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", ["image", "image_seg", "image_depth"])
def test_gen_videos_matches_jax(both_clis, tmp_path, mode):
    from ide3d_tpu.apps import gen_videos as jgen_videos

    common = ["--network", "x", "--seeds", "0-1", "--num-keyframes", "2", "--w-frames", "2",
              "--chunk", "2", "--image-mode", mode, "--num-steps", "4"]
    jgen_videos.main(common + ["--output", str(tmp_path / "j.mp4")])
    out = gen_videos.main(common + ["--output", str(tmp_path / "t.mp4"), "--device", "cpu"])
    (want,), (got,) = both_clis["jax"], both_clis["port"]
    assert out["frames"] == len(got) == 4
    assert got[0].shape == (32, 32 if mode == "image" else 64, 3)
    _frames_within_one_level(got, want)


def test_extract_shapes_matches_jax(both_clis, tmp_path):
    """16^3 points in chunks of 1000: a padded tail of 904 points to trim."""
    from ide3d_tpu.apps import extract_shapes as jextract

    common = ["--network", "x", "--seeds", "3", "--voxel-resolution", "16", "--max-batch", "1000"]
    jextract.main(common + ["--outdir", str(tmp_path / "j")])
    extract_shapes.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"])
    want, got = np.load(tmp_path / "j" / "3.npy"), np.load(tmp_path / "t" / "3.npy")
    assert got.shape == (16, 16, 16) and got.dtype == np.float32
    _sigma_close(got, want)


def test_marching_tetrahedra_matches_jax():
    rng = np.random.RandomState(0)
    x = np.linspace(-1, 1, 12)
    grid = np.sqrt(x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2)
    sigma = (0.7 - grid + 0.05 * rng.randn(12, 12, 12)).astype(np.float32)
    vj, fj = jmarching.marching_tetrahedra(sigma, level=0.0)
    vt, ft = tmarching.marching_tetrahedra(sigma, level=0.0)
    assert len(ft) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-6)


def _read_obj(path):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            head, *rest = line.split()
            (verts if head == "v" else faces).append([float(v) for v in rest])
    return np.array(verts), np.array(faces)


def test_render_mesh_matches_jax(both_clis, tmp_path):
    from ide3d_tpu.apps import render_mesh as jrender_mesh

    common = ["--network", "x", "--seed", "1", "--voxel-resolution", "16", "--frames", "3"]
    jrender_mesh.main(common + ["--outdir", str(tmp_path / "j"), "--video", str(tmp_path / "j.mp4")])
    out = render_mesh.main(common + ["--outdir", str(tmp_path / "t"),
                                     "--video", str(tmp_path / "t.mp4"), "--device", "cpu"])
    vj, fj = _read_obj(tmp_path / "j" / "1.obj")
    vt, ft = _read_obj(tmp_path / "t" / "1.obj")
    assert out["faces"] == len(ft) > 0
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-4)
    with open(tmp_path / "j" / "1.ply", "rb") as f:
        ply_j = f.read()
    with open(tmp_path / "t" / "1.ply", "rb") as f:
        ply_t = f.read()
    assert ply_t.split(b"end_header")[0] == ply_j.split(b"end_header")[0]
    (want,), (got,) = both_clis["jax"], both_clis["port"]
    _frames_within_one_level(got, want)


def test_avg_spectra_matches_jax(both_clis, bridged, tmp_path, monkeypatch):
    """Real images: both CLIs' spectra on the same files (rtol 1e-4).
    Generated images: the port's G(z, c) against JAX's (2e-4 x scale), each
    CLI's spectra against the JAX spectrum of its own images (rtol 1e-4), and
    the two CLIs' generated spectra against each other within 4e-4 of their
    peak (a squared magnitude, so twice the images' 2e-4). They are not held
    bin by bin at rtol: they span ~11 decades, and the fp32 rounding of the
    images (~1e-4 at |x| ~40) moves the faintest bins by ~1e-3 of themselves."""
    from ide3d_tpu.apps import avg_spectra as javg

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        PIL.Image.fromarray(rng.randint(0, 255, (24, 24, 3), np.uint8)).save(imgs / f"{i}.png")
    javg.main(["--data", str(imgs), "--num", "3", "--out", str(tmp_path / "jd.npz")])
    avg_spectra.main(["--data", str(imgs), "--num", "3", "--out", str(tmp_path / "td.npz")])

    made = []
    generated = avg_spectra.generated_images
    monkeypatch.setattr(avg_spectra, "generated_images",
                        lambda *a, **k: made.append(generated(*a, **k)) or made[-1])
    javg.main(["--network", "x", "--num", "2", "--out", str(tmp_path / "j.npz")])
    avg_spectra.main(["--network", "x", "--num", "2", "--out", str(tmp_path / "t.npz"),
                      "--device", "cpu"])
    jG, params, _ = bridged
    c = np.asarray(CANONICAL_POSE_25)[None]
    jax_imgs = np.stack([np.asarray(jax.jit(lambda p, z, c: jG(p, z, c))(
        params, np.random.RandomState(i).randn(1, 512).astype(np.float32), c))[0] for i in range(2)])
    (port_imgs,) = made
    assert np.isfinite(port_imgs).all() and port_imgs.shape == jax_imgs.shape == (2, 32, 32, 3)
    scale = max(1.0, float(np.abs(jax_imgs).max()))
    assert float(np.abs(port_imgs - jax_imgs).max()) <= 2e-4 * scale

    pairs = (("jd", "td", None), ("j", None, jax_imgs), ("t", None, port_imgs))
    for j, t, images in pairs:
        got = np.load(tmp_path / f"{t or j}.npz")
        if images is None:
            want = np.load(tmp_path / f"{j}.npz")
            want = {k: want[k] for k in ("spectrum", "radial")}
        else:
            spec = javg.power_spectrum(images)
            want = {"spectrum": spec, "radial": javg.azimuthal_average(spec)}
        for k in ("spectrum", "radial"):
            assert np.isfinite(got[k]).all() and got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    for k in ("spectrum", "radial"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=4e-4 * float(want[k].max()))


@pytest.mark.parametrize("ref_compat", [False, True])
def test_load_generator_reads_a_train_gan_snapshot(tmp_path, ref_compat):
    """A snapshot as train_gan writes it ({G, D, G_ema, ...} + the config in
    meta.json) loads back as its G_ema, configuration included."""
    extra = dict(vb_ref_compat=True, raw_head="slice", mapping_num_layers=2,
                 vb_resolutions_override=(4, 8, 16), vb_channels_override=(32, 24, 16)) \
        if ref_compat else {}
    cfg = GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4), **extra)
    G_ema, G = Ide3dGenerator(cfg).init(1), Ide3dGenerator(cfg).init(2)
    snap = str(tmp_path / "snapshot-final")
    save_checkpoint(snap, {"G": G.state_dict(), "G_ema": G_ema.state_dict(), "pl_mean": torch.zeros(())},
                    config=cfg, step=2, ada_p=0.1)
    loaded = tcommon.load_generator(snap, device="cpu")
    assert loaded.cfg == cfg and not loaded.training
    z = torch.from_numpy(np.random.RandomState(0).randn(2, 512).astype(np.float32))
    c = torch.from_numpy(np.tile(CANONICAL_POSE_25, (2, 1)))
    with torch.no_grad():
        want, got = G_ema(z, c, truncation_psi=0.7), loaded(z, c, truncation_psi=0.7)
    assert torch.isfinite(got).all() and torch.equal(got, want)
    with pytest.raises(FileNotFoundError, match="load_network_pkl"):
        tcommon.load_generator(str(tmp_path / "net.pkl"), device="cpu")


class _Stop(Exception):
    pass


def test_entry_points_reach_the_cpu_only_when_asked(monkeypatch, tmp_path):
    seen = []

    def fake_load(network, device="cuda"):
        seen.append(str(device))
        raise _Stop

    monkeypatch.setattr(tcommon, "load_generator", fake_load)
    # The data-parallel CLIs load on their rank's device: a group of one on the
    # device type the CLI asks for (here without a process group)
    monkeypatch.setattr(mesh, "launch", lambda fn, world, device_type, *args, **kw:
                        fn(mesh.Group(device=torch.device(device_type)), *args))
    calls = {
        gen_videos.main: ["--network", "x", "--seeds", "0", "--output", str(tmp_path / "v.mp4")],
        extract_shapes.main: ["--network", "x", "--seeds", "0", "--outdir", str(tmp_path)],
        render_mesh.main: ["--network", "x", "--outdir", str(tmp_path)],
        avg_spectra.main: ["--network", "x", "--out", str(tmp_path / "s.npz")],
    }
    for main, argv in calls.items():
        for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
            with pytest.raises(_Stop):
                main(argv + extra)
            assert seen.pop() == want, main.__module__
    for fn in (torch_import.load_network_pkl, torch_import.import_generator,
               torch_import.import_discriminator, torch_import.import_encoder):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    assert inspect.signature(tcommon.load_generator).parameters["device"].default == "cuda"


def test_new_modules_leave_jax_out():
    code = ("import sys, ide3d_tpu_torch.io, ide3d_tpu_torch.io.torch_import, "
            "ide3d_tpu_torch.apps.gen_videos, ide3d_tpu_torch.apps.extract_shapes, "
            "ide3d_tpu_torch.apps.render_mesh, ide3d_tpu_torch.apps.avg_spectra, "
            "ide3d_tpu_torch.apps.web_ui, ide3d_tpu_torch.utils.marching; "
            "print('jax' in sys.modules, any(m.split('.')[0] == 'ide3d_tpu' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip() == "False False"
