"""The port's Painter edit loop against the JAX package, on the CPU.

The tiny generator of tests/test_torch_generator.py and a HybridEncoder at its
width are initialised by JAX and bridged into the port through io/from_jax.py;
the same seeded inputs go through `make_edit_step` and `PainterSession` on both
sides. Float outputs within 2e-4 (the golden test's tolerance) times the
reference's scale, max(1, max |ref|): the random tiny G's images reach |x| ~ 90
once the encoder's rows replace the latent, and the port agrees with JAX to
~1e-5 of that scale. uint8 outputs within 1.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu import render as jrender
from ide3d_tpu.apps import painter as jpainter
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models.encoder import HybridEncoder as JHybridEncoder
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.utils.seg import mask2onehot as jmask2onehot
from ide3d_tpu_torch.apps import common, gen_images, painter
from ide3d_tpu_torch.apps.mask_canvas import MaskCanvas
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.encoder import HybridEncoder
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
ATOL = 2e-4


@pytest.fixture(scope="module")
def bridged():
    """JAX (G, E, params) and the port's G and E holding the same weights."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    g_params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    n_geo = jG.synthesis.num_ws_geo
    jE = JHybridEncoder(size=32, n_latents_app=jG.num_ws - n_geo, n_latents_geo=n_geo)
    e_params = jax.jit(jE.init)(jax.random.PRNGKey(1))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, g_params))
    E = HybridEncoder(size=32, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo)
    load_jax_params(E, jax.tree_util.tree_map(np.asarray, e_params))
    return {"jG": jG, "jE": jE, "g_params": g_params, "e_params": e_params,
            "G": G.eval(), "E": E.eval()}


def _assert_close(name, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=ATOL * scale, rtol=ATOL, err_msg=name)


def _assert_u8_close(name, got, ref):
    assert got.dtype == np.uint8 and got.shape == ref.shape, name
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1, name


def _mask(R, seed=0):
    m = np.random.RandomState(seed).randint(0, 19, (R, R)).astype(np.uint8)
    m[4:12, 4:12] = 13
    return m


def _session(bridged, **kw):
    return painter.PainterSession(G=bridged["G"], E=bridged["E"], device="cpu", **kw)


def _jsession(bridged, **kw):
    return jpainter.PainterSession(G=bridged["jG"], E=bridged["jE"], g_params=bridged["g_params"],
                                   e_params=bridged["e_params"], **kw)


def test_num_ws_geo(bridged):
    assert bridged["G"].synthesis.num_ws_geo == bridged["jG"].synthesis.num_ws_geo == 4
    assert Ide3dGenerator(GeneratorConfig()).synthesis.num_ws_geo == 8


@torch.inference_mode()
def test_render_coarse_with_table_equals_uncached(bridged):
    """`table=` (the plane cache) gives the state the planes give, and a frame
    rendered from `plane_table` equals the uncached frame."""
    S = bridged["G"].synthesis
    ws = bridged["G"].mapping(torch.randn(1, 512, generator=torch.Generator().manual_seed(0)),
                              torch.as_tensor(jrender.CANONICAL_POSE_25)[None])
    img_v, seg_v = S.generate_planes(ws)
    c = _session(bridged).camera(0.2, -0.1)
    cam2world = c[:, :16].reshape(-1, 4, 4)
    rp = S.cfg.render
    ref = S.renderer.render_coarse(img_v, seg_v, cam2world, rp)
    got = S.renderer.render_coarse(None, None, cam2world, rp,
                                   table=S.renderer.build_table(img_v, seg_v))
    for k in ("coarse", "fine_z", "z_vals"):
        assert torch.isfinite(got[k]).all()
        assert torch.equal(got[k], ref[k]), k
    img, seg = S(ws, c, return_seg=True)
    img_t, seg_t = S(ws, c, return_seg=True, table=S.plane_table(ws))
    assert torch.isfinite(img_t).all() and torch.equal(img_t, img) and torch.equal(seg_t, seg)


def test_free_view_trajectory_matches_jax():
    for kind in ("orbit", "front"):
        assert painter.free_view_trajectory(kind) == jpainter.free_view_trajectory(kind)
    with pytest.raises(ValueError):
        painter.free_view_trajectory("barrel-roll")


@pytest.mark.parametrize("lock", [True, False])
def test_make_edit_step_matches_jax(bridged, lock):
    """rec_ws, img and seg scores of the full step and of `.from_render`."""
    jG, G = bridged["jG"], bridged["G"]
    R = G.cfg.img_resolution
    rng = np.random.RandomState(7)
    z = rng.randn(1, 512).astype(np.float32)
    c0 = np.asarray(jrender.CANONICAL_POSE_25)[None]
    w_prev = np.asarray(jG.mapping(bridged["g_params"]["mapping"], jnp.asarray(z),
                                   jnp.asarray(c0), truncation_psi=0.7))
    c = np.asarray(jrender.make_label_25(jrender.look_at_pose(
        0.2 + np.pi / 2, 0.05 + np.pi / 2, [0.0, 0.0, 0.0], radius=2.7)))
    seg_pm = np.asarray(jmask2onehot(jnp.asarray(_mask(R)[None]))) * 2.0 - 1.0
    gen_img = rng.uniform(-1, 1, (1, R, R, 3)).astype(np.float32)

    jstep = jpainter.make_edit_step(jG, bridged["jE"], lock_appearance=lock)
    step = painter.make_edit_step(G, bridged["E"], lock_appearance=lock)
    args = [jnp.asarray(a) for a in (seg_pm, w_prev, c)]
    jp = (bridged["g_params"], bridged["e_params"])
    refs = {"step": jstep(*jp, *args),
            "from_render": jstep.from_render(*jp, jnp.asarray(gen_img), *args)}
    t = [torch.from_numpy(np.array(a)) for a in (seg_pm, w_prev, c)]
    with torch.inference_mode():
        gots = {"step": step(*t), "from_render": step.from_render(torch.from_numpy(gen_img), *t)}
    for path in refs:
        for name, got, ref in zip(("img", "seg", "rec_ws"), gots[path], refs[path]):
            _assert_close(f"{path} {name}", got.numpy(), np.asarray(ref))
    if lock:  # the appearance rows are w_prev's
        np.testing.assert_array_equal(gots["step"][2][:, 4:].numpy(), w_prev[:, 4:])


def test_painter_session_matches_jax(bridged):
    """set_seed, view (plane cache), a new-view edit and a stroke (frame cache)."""
    R = bridged["G"].cfg.img_resolution
    js, ts = _jsession(bridged), _session(bridged)
    _assert_close("set_seed w", ts.set_seed(3).numpy(), np.asarray(js.set_seed(3)))
    for yaw, pitch in ((0.3, -0.1), (-0.2, 0.0)):
        for name, got, ref in zip(("rgb", "seg"), ts.view(yaw, pitch), js.view(yaw, pitch)):
            _assert_u8_close(f"view {yaw} {name}", got, ref)
    mask = _mask(R)
    for yaw in (0.1, 0.1):  # a new view, then a stroke at that view
        for name, got, ref in zip(("rgb", "seg"), ts.edit(mask, yaw), js.edit(mask, yaw)):
            _assert_u8_close(f"edit {yaw} {name}", got, ref)
        _assert_close("edit w", ts.w.numpy(), np.asarray(js.w))
        mask = _mask(R, seed=1)


def _counting(G):
    """Counts of G passes (render_fine calls, one K1 launch each on the card)
    and of generate_planes calls; returns (counts, undo)."""
    S = G.synthesis
    counts = {"passes": 0, "planes": 0}

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def counted(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)

        setattr(obj, name, counted)

    wrap(S.renderer, "render_fine", "passes")
    wrap(S, "generate_planes", "planes")

    def undo():
        del S.renderer.render_fine, S.generate_planes

    return counts, undo


def test_session_caches_count_passes(bridged):
    """The G passes and plane generations of each call, as chip_smoke.py
    counts them on the card: cached views make no planes, a new-view edit makes
    2 passes, a stroke 1, a view of a new latent makes its planes once."""
    R = bridged["G"].cfg.img_resolution
    sess = _session(bridged)
    counts, undo = _counting(bridged["G"])
    try:
        def expect(passes, planes):
            assert (counts["passes"], counts["planes"]) == (passes, planes)
            counts.update(passes=0, planes=0)

        sess.set_seed(3)
        sess.view(0.0, 0.0)
        expect(1, 1)
        sess.view(0.3)
        sess.view(-0.3)
        expect(2, 0)
        mask = _mask(R)
        sess.edit(mask, 0.1)
        expect(2, 2)
        sess.edit(mask, 0.1)
        sess.edit(_mask(R, 1), 0.1)
        expect(2, 2)
        sess.view(0.1)
        expect(1, 1)
        frames = list(sess.render_trajectory("orbit", stride=30, ws=sess.w))
        expect(4, 1)
        assert len(frames) == 4 and frames[0].shape == (R, R, 3) and frames[0].dtype == np.uint8
    finally:
        undo()


def test_frame_cache_stroke_equals_full_edit(bridged):
    """A stroke reuses the previous frame as the first G pass; it must equal
    the uncached edit."""
    R = bridged["G"].cfg.img_resolution
    mask1, mask2 = np.zeros((R, R), np.uint8), _mask(R)

    def run(use_cache):
        sess = _session(bridged)
        sess.set_seed(3)
        sess.edit(mask1, yaw=0.15)  # fills the frame cache
        if not use_cache:
            sess._frame_cache = None
        return sess.edit(mask2, yaw=0.15), sess.w

    (img_c, seg_c), w_c = run(True)
    (img_u, seg_u), w_u = run(False)
    _assert_u8_close("stroke rgb", img_c, img_u)
    _assert_u8_close("stroke seg", seg_c, seg_u)
    _assert_close("stroke rec_ws", w_c.numpy(), w_u.numpy())


def test_record_and_replay(bridged, tmp_path):
    R = bridged["G"].cfg.img_resolution
    sess = _session(bridged, record=True)
    sess.set_seed(0)
    mask = np.zeros((R, R), np.uint8)
    frames = [sess.edit(mask, yaw=0.1)]
    mask[4:10, 4:10] = 13
    frames.append(sess.edit(mask, yaw=-0.1))
    log = str(tmp_path / "session.npz")
    sess.save_log(log)

    sess2 = _session(bridged)
    sess2.set_seed(0)
    replayed = list(sess2.replay_log(log))
    assert len(replayed) == 2
    for (rgb, seg), (rgb2, seg2) in zip(frames, replayed):
        _assert_u8_close("replay rgb", rgb2, rgb)
        _assert_u8_close("replay seg", seg2, seg)
    with pytest.raises(RuntimeError):
        sess2.save_log(str(tmp_path / "empty.npz"))


def test_session_needs_a_latent(bridged):
    sess = _session(bridged)
    with pytest.raises(RuntimeError):
        sess.view()
    ws = bridged["G"].mapping(torch.zeros(1, 512), torch.as_tensor(jrender.CANONICAL_POSE_25)[None])
    sess.set_inversion(ws.detach())
    assert sess.inversion and sess.w is not None
    rgb, seg = sess.view(0.1)
    assert rgb.shape == seg.shape == (32, 32, 3)


def test_mask_canvas_tools():
    c = MaskCanvas(size=64)
    c.rect(10, 10, 30, 30, cls=13)
    assert (c.mask[10:30, 10:30] == 13).all()
    assert c.mask[0, 0] == 0
    c.brush([(40, 40), (50, 50)], cls=1, radius=3)
    assert c.mask[45, 45] == 1
    c.fill(0, 0, cls=18)  # fill background
    assert c.mask[0, 0] == 18
    assert c.mask[12, 12] == 13  # enclosed region untouched
    # undo chain unwinds all three ops
    assert c.undo() and c.mask[0, 0] == 0
    assert c.undo() and c.mask[45, 45] == 0
    assert c.undo() and (c.mask == 0).all()
    assert c.redo() and (c.mask[10:30, 10:30] == 13).all()
    col = c.to_color()
    assert col.shape == (64, 64, 3) and col.dtype == np.uint8
    with pytest.raises(ValueError):
        c.load(np.zeros((32, 32), np.uint8))


class _Stop(Exception):
    pass


def test_entry_points_reach_the_cpu_only_when_asked(monkeypatch):
    """gen_images and load_generator default to the card; nothing falls back
    to the CPU when it is missing."""
    seen = []

    def fake_load(network, device="cuda"):
        seen.append(torch.device(device))
        raise _Stop

    monkeypatch.setattr(gen_images, "load_generator", fake_load)
    for argv, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
        with pytest.raises(_Stop):
            gen_images.main(["--network", "random:0:tiny", "--seeds", "1", "--outdir", "x", *argv])
        assert seen.pop() == torch.device(want)

    moved = []
    monkeypatch.setattr(Ide3dGenerator, "to", lambda self, *a, **kw: moved.append(a) or self)
    common.load_generator("random:0:tiny")
    assert moved[-1] == ("cuda",)
    assert painter.PainterSession.__dataclass_fields__["device"].default == "cuda"


def test_import_leaves_jax_out():
    code = ("import sys, ide3d_tpu_torch.apps.web_ui, ide3d_tpu_torch.apps.painter, "
            "ide3d_tpu_torch.apps.mask_canvas, ide3d_tpu_torch.models.encoder; "
            "print('jax' in sys.modules, 'ide3d_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False False"
