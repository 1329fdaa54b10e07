"""The port's Painter web UI: every route over a tiny session on the CPU
(`build_session(tiny=True, device="cpu")`), as tests/test_webui.py drives the
JAX package's, plus the device defaults of its entry points."""

import base64
import io
import json
import threading

import numpy as np
import PIL.Image
import pytest
import torch

from ide3d_tpu_torch.apps import web_ui
from ide3d_tpu_torch.apps.painter import free_view_trajectory
from ide3d_tpu_torch.utils.seg import COLOR_MAP
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

R = 64


@pytest.fixture(scope="module")
def app():
    return web_ui.PainterWebApp(web_ui.build_session("random:0", tiny=True, device="cpu"))


def _json(resp):
    status, ctype, payload = resp
    assert status == 200, payload
    assert ctype == "application/json"
    return json.loads(payload)


def _png(b64):
    img = PIL.Image.open(io.BytesIO(base64.b64decode(b64)))
    assert img.size == (R, R)
    return np.asarray(img)


def test_index_and_meta(app):
    status, ctype, payload = app.handle("GET", "/", {}, b"")
    assert status == 200 and ctype == "text/html"
    assert b"Apply edit" in payload

    meta = _json(app.handle("GET", "/api/meta", {}, b""))
    assert meta["resolution"] == R
    assert meta["classes"]["hair"] == 13
    assert len(meta["palette"]) == 19


def test_seed_view_edit_loop(app):
    out = _json(app.handle("POST", "/api/seed", {}, json.dumps({"seed": 3, "trunc": 0.7}).encode()))
    assert out["render"] and out["seg_ids"]
    ids = np.frombuffer(base64.b64decode(out["seg_ids"]), np.uint8)
    assert ids.shape == (R * R,) and ids.max() < 19

    # free-view re-render (no edit): the latent must NOT advance
    w_before = app.session.w.clone()
    out_v = _json(app.handle("GET", "/api/view", {"yaw": "0.3", "pitch": "-0.1"}, b""))
    assert _png(out_v["render"]).shape == (R, R, 3)
    assert torch.equal(app.session.w, w_before)

    # paint a hair rectangle onto the mask and apply the edit
    mask = ids.reshape(R, R).copy()
    mask[5:20, 5:20] = 13
    body = json.dumps({"mask": base64.b64encode(mask.reshape(-1)).decode(),
                       "yaw": 0.1, "pitch": 0.0}).encode()
    out_e = _json(app.handle("POST", "/api/edit", {}, body))
    assert out_e["render"] and out_e["seg_ids"]
    # the edit advances the session latent (run_UI.py:203 self.w = rec_ws)
    assert float((app.session.w - w_before).abs().max()) > 0
    _png(out_e["render"])


def test_orbit_and_session_video(app):
    """Free-view capture and the log -> video round trip give playable files."""
    orbit = free_view_trajectory("orbit")
    front = free_view_trajectory("front")
    assert len(orbit) == 120 and len(front) == 240
    assert abs(orbit[0][0]) < 1e-6 and abs(orbit[0][1]) < 1e-6  # starts frontal
    yaws = np.asarray([y for y, _ in orbit])
    assert yaws.min() < -0.6 and yaws.max() > 0.6  # 0.3pi..0.7pi sweep

    out = _json(app.handle("POST", "/api/orbit", {},
                           json.dumps({"type": "orbit", "stride": 30}).encode()))
    assert out["frames"] == 4 and out["ext"] in ("mp4", "gif")
    data = base64.b64decode(out["video"])
    assert len(data) > 100
    if out["ext"] == "gif":
        assert data[:3] == b"GIF"

    # session video: the edits so far (recorded by the /api/edit route), stitched
    out_s = _json(app.handle("GET", "/api/session_video", {}, b""))
    assert out_s["frames"] >= 1 and out_s["video"]

    with pytest.raises(ValueError):
        app.orbit({"type": "barrel-roll"})


def test_unknown_route(app):
    status, _, _ = app.handle("GET", "/nope", {}, b"")
    assert status == 404


def test_load_mask_roundtrip(app):
    """'Open real mask': a grayscale class-id PNG and a palette-colored PNG both
    land as canvas ids at the session resolution."""
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 19, (128, 128)).astype(np.uint8)  # off-resolution input

    buf = io.BytesIO()
    PIL.Image.fromarray(ids, mode="L").save(buf, "PNG")
    out = _json(app.handle("POST", "/api/load_mask", {},
                           json.dumps({"png": base64.b64encode(buf.getvalue()).decode()}).encode()))
    got = np.frombuffer(base64.b64decode(out["seg_ids"]), np.uint8).reshape(R, R)
    assert got.max() < 19
    assert set(np.unique(got)) <= set(np.unique(ids))  # nearest-neighbour resize

    buf2 = io.BytesIO()
    PIL.Image.fromarray(COLOR_MAP.astype(np.uint8)[ids]).save(buf2, "PNG")
    out2 = _json(app.handle("POST", "/api/load_mask", {},
                            json.dumps({"png": base64.b64encode(buf2.getvalue()).decode()}).encode()))
    got2 = np.frombuffer(base64.b64decode(out2["seg_ids"]), np.uint8).reshape(R, R)
    np.testing.assert_array_equal(got2, got)  # palette inversion agrees with grayscale


def test_seg_ids_invert_the_palette():
    """The palette lookup gives the class ids that the JAX web UI's
    nearest-colour search gives, and refuses colours outside the palette."""
    import types

    from ide3d_tpu.apps.web_ui import PainterWebApp as JPainterWebApp

    ids = np.random.RandomState(6).randint(0, 19, (R, R)).astype(np.uint8)
    color = COLOR_MAP.astype(np.uint8)[ids]
    got = web_ui.PainterWebApp._seg_ids(color)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ids.reshape(-1))
    np.testing.assert_array_equal(got, JPainterWebApp._seg_ids(types.SimpleNamespace(), color))
    color[0, 0] = (1, 2, 3)
    with pytest.raises(ValueError):
        web_ui.PainterWebApp._seg_ids(color)


def test_worker_threads_run_in_inference_mode(app):
    """The server calls the session from worker threads; the session enters
    inference mode itself there, so autograd records nothing."""
    _json(app.handle("POST", "/api/seed", {}, json.dumps({"seed": 1}).encode()))
    results = []

    def worker():
        results.append(app.handle("GET", "/api/view", {"yaw": "0.2"}, b""))
        results.append(app.session._frame_cache[2].is_inference())

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    assert results[0][0] == 200 and results[1] is True


class _Stop(Exception):
    pass


def test_entry_points_default_to_the_card(monkeypatch):
    """build_session and main run on cuda unless passed cpu."""
    seen = []

    def fake_build(network, encoder=None, tiny=False, device="cuda"):
        seen.append(device)
        raise _Stop

    monkeypatch.setattr(web_ui, "build_session", fake_build)
    for argv, want in (([], "cuda"), (["--tiny", "--device", "cpu"], "cpu")):
        with pytest.raises(_Stop):
            web_ui.main(argv)
        assert seen.pop() == want
    monkeypatch.undo()

    from ide3d_tpu_torch.apps import common

    def fake_load(network, device="cuda"):
        seen.append(device)
        raise _Stop

    monkeypatch.setattr(common, "load_generator", fake_load)
    with pytest.raises(_Stop):
        web_ui.build_session("random:0")
    assert seen.pop() == "cuda"


def test_build_session_loads_an_encoder_checkpoint(app, tmp_path):
    """--encoder: the E state dict of a checkpoint written by
    io/checkpoint.save_checkpoint gives the session's encoder the weights of
    HybridEncoder.init(1) with that state loaded, output for output."""
    from ide3d_tpu_torch.io.checkpoint import save_checkpoint
    from ide3d_tpu_torch.models.encoder import HybridEncoder

    E0 = app.session.E  # from seed 1
    trained = HybridEncoder(size=R, n_latents_app=E0.n_latents_app, n_latents_geo=E0.n_latents_geo,
                            dtype="float32").init(7)
    save_checkpoint(str(tmp_path / "enc"), {"E": trained.state_dict()}, step=1)
    sess = web_ui.build_session("random:0", encoder=str(tmp_path / "enc"), tiny=True, device="cpu")
    want = HybridEncoder(size=R, n_latents_app=E0.n_latents_app, n_latents_geo=E0.n_latents_geo,
                         dtype="float32").init(1)
    want.load_state_dict(torch.load(tmp_path / "enc" / "state.pt", weights_only=True)["E"])
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, R, R, 3)).astype(np.float32))
    seg = torch.from_numpy(rng.uniform(-1, 1, (1, R, R, 19)).astype(np.float32))
    with torch.no_grad():
        got, ref, base = sess.E(img, seg), want.eval()(img, seg), E0(img, seg)
    assert torch.isfinite(got).all() and got.shape == (1, E0.n_latents_geo + E0.n_latents_app, 512)
    assert torch.equal(got, ref)
    assert not torch.allclose(got, base)  # not the seed-1 encoder
