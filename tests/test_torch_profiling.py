"""The port's spans (utils/profiling.span) on the CPU: nothing is recorded and
nothing changes while no profiler records; under torch.profiler the G stages,
the video chunk, the Painter request and the GAN step's phases land in the
trace as nested `user_annotation` events; an export taken while a profiler
records holds no profiler node."""

import base64
import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ide3d_tpu_torch.apps import gen_videos, painter
from ide3d_tpu_torch.apps.common import PRESETS
from ide3d_tpu_torch.apps.web_ui import PainterWebApp
from ide3d_tpu_torch.io.export import _Frame
from ide3d_tpu_torch.models import generator
from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
from ide3d_tpu_torch.models.encoder import HybridEncoder
from ide3d_tpu_torch.models.generator import Ide3dGenerator
from ide3d_tpu_torch.render.camera import CANONICAL_POSE_25
from ide3d_tpu_torch.train import gan
from ide3d_tpu_torch.utils import profiling
from ide3d_tpu_torch.utils.profiling import span
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

STAGES = ["G.planes", "G.render", "G.finish"]


@pytest.fixture(scope="module")
def G():
    return Ide3dGenerator(PRESETS["tiny"]).init(0).eval().requires_grad_(False)


def _inputs(G, batch=1, seed=0):
    rng = np.random.RandomState(seed)
    ws = torch.as_tensor(rng.randn(batch, G.num_ws, G.cfg.w_dim).astype(np.float32))
    c = torch.as_tensor(np.stack([CANONICAL_POSE_25] * batch).astype(np.float32))
    return ws, c


def _spans(prof, tmp_path) -> list:
    """The trace's user annotations as (start us, end us, name), by start then
    longest first, read from its Chrome trace as the benchmark reads it."""
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def _inside(spans, outer, name) -> list:
    """The spans called `name` within the span `outer`."""
    return [s for s in spans if s[2] == name and outer[0] <= s[0] and s[1] <= outer[1]]


def _recorded():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_a_span_is_a_shared_no_op_and_the_frame_is_unchanged(G, monkeypatch):
    assert span("G.render") is span("G.render")
    ws, c = _inputs(G)
    with torch.no_grad():
        spanned = G.synthesis(ws, c, return_seg=True)

    def refuse(*args, **kwargs):
        raise AssertionError("a span was recorded with no profiler running")

    monkeypatch.setattr(profiling._Span, "__init__", refuse)
    with torch.no_grad():
        again = G.synthesis(ws, c, return_seg=True)
        monkeypatch.setattr(generator, "span", lambda name: contextlib.nullcontext())
        bare = G.synthesis(ws, c, return_seg=True)
    for a, b, d in zip(spanned, again, bare):
        assert torch.equal(a, b) and torch.equal(a, d)


def test_a_profiled_frame_holds_its_three_stages_in_order_and_is_unchanged(G, tmp_path):
    ws, c = _inputs(G, batch=2)
    with torch.no_grad():
        want = G.synthesis(ws, c, return_seg=True)
        with _recorded() as prof:
            with span("frame"):
                got = G.synthesis(ws, c, return_seg=True)
    spans = _spans(prof, tmp_path)
    frame = [s for s in spans if s[2] == "frame"]
    assert len(frame) == 1
    inner = [s for s in spans if s[2] in STAGES]
    assert [s[2] for s in inner] == STAGES
    assert all(_inside(spans, frame[0], s[2]) == [s] for s in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_planes_are_absent_when_the_frame_is_given_its_table(G, tmp_path):
    ws, c = _inputs(G)
    with torch.no_grad():
        table = G.synthesis.plane_table(ws)
        with _recorded() as prof:
            G.synthesis(ws, c, table=table)
    assert [s[2] for s in _spans(prof, tmp_path)] == ["G.render", "G.finish"]


def test_a_video_chunk_holds_the_frame_and_the_tiles_follow_it(G, tmp_path):
    ws, c = _inputs(G, batch=4, seed=1)
    with torch.no_grad(), _recorded() as prof:
        tiles = gen_videos.render_chunks(G, ws.numpy(), c.numpy(), G.cfg.render, "image_seg",
                                         chunk=2, device="cpu")
    assert len(tiles) == 4
    spans = _spans(prof, tmp_path)
    chunks = [s for s in spans if s[2] == "video.chunk"]
    assert len(chunks) == 2 and len([s for s in spans if s[2] == "video.tiles"]) == 2
    for ch in chunks:
        assert [s[2] for s in spans if s[2] in STAGES and ch[0] <= s[0] and s[1] <= ch[1]] == STAGES
    assert not [s for s in spans if s[2] == "video.wait"]  # the CPU copies synchronously


@pytest.fixture(scope="module")
def app(G):
    n_geo = G.synthesis.num_ws_geo
    E = HybridEncoder(size=G.cfg.img_resolution, n_latents_app=G.num_ws - n_geo,
                      n_latents_geo=n_geo, w_dim=G.cfg.w_dim).init(1).eval()
    app = PainterWebApp(painter.PainterSession(G=G, E=E, device="cpu"))
    status, _, _ = app.handle("POST", "/api/seed", {}, json.dumps({"seed": 3}).encode())
    assert status == 200
    return app


def _stroke(app, yaw, tmp_path) -> list:
    R = app.session.G.cfg.img_resolution
    mask = np.random.RandomState(7).randint(0, 19, (R, R)).astype(np.uint8)
    body = json.dumps({"mask": base64.b64encode(mask.reshape(-1)).decode(), "yaw": yaw}).encode()
    with _recorded() as prof:
        status, _, _ = app.handle("POST", "/api/edit", {}, body)
    assert status == 200
    return _spans(prof, tmp_path)


def test_a_painter_stroke_renders_twice_at_a_new_view_and_once_at_the_same(app, tmp_path):
    for yaw, passes in ((0.3, 2), (0.3, 1), (-0.2, 2)):
        spans = _stroke(app, yaw, tmp_path)
        request = [s for s in spans if s[2] == "web.request"]
        assert len(request) == 1 and spans[0] == request[0]  # the outermost span
        edit = _inside(spans, request[0], "painter.edit")
        assert len(edit) == 1
        assert len(_inside(spans, edit[0], "G.render")) == passes
        assert len(_inside(spans, edit[0], "painter.encode")) == 1
        assert len(_inside(spans, edit[0], "painter.to_host")) == 1
        png = _inside(spans, request[0], "web.png")
        assert len(png) == 1 and png[0][0] >= edit[0][1]  # the PNG is encoded after the edit


TINY_D = dict(img_resolution=32, img_channels=25, channel_base=512, channel_max=32,
              dtype="float32")


def test_a_train_step_holds_its_phases_and_r1_only_on_its_interval(tmp_path):
    tcfg = gan.GanTrainConfig(r1_interval=2)
    G = Ide3dGenerator(PRESETS["tiny"]).init(0)
    D = Discriminator(DiscriminatorConfig(**TINY_D)).init(1)
    state = gan.init_gan_state(G, D, tcfg)
    step = gan.make_gan_train_step(tcfg)
    rng = np.random.RandomState(0)
    batch = {"img": torch.as_tensor(rng.randint(0, 256, (4, 32, 32, 3), np.uint8)),
             "seg": torch.as_tensor(rng.randint(0, 19, (4, 32, 32), np.uint8)),
             "c": torch.as_tensor(np.stack([CANONICAL_POSE_25] * 4).astype(np.float32))}
    gen = torch.Generator().manual_seed(1)
    with _recorded() as prof:
        for _ in range(2):
            state, _ = step(state, batch, gen, 0.2)
    spans = _spans(prof, tmp_path)
    steps = [s for s in spans if s[2] == "gan.step"]
    assert len(steps) == 2
    for i, st in enumerate(steps):
        g, d = _inside(spans, st, "gan.g_phase"), _inside(spans, st, "gan.d_phase")
        assert len(g) == 1 and len(d) == 1 and g[0][1] <= d[0][0]  # G first
        r1 = _inside(spans, d[0], "gan.r1")
        assert len(r1) == (1 if i == 0 else 0)


def test_an_export_taken_while_a_profiler_records_has_no_profiler_node(G):
    ws, c = _inputs(G)
    with torch.no_grad(), _recorded():
        ep = torch.export.export(_Frame(G.synthesis, G.cfg.render, True).eval(), (ws, c))
    targets = [str(n.target) for n in ep.graph_module.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_a_decorated_function_asks_at_each_call(tmp_path, monkeypatch):
    @span("outer")
    def work(x):
        return x + 1

    assert work(1) == 2
    with _recorded() as prof:
        assert work(2) == 3
    assert [s[2] for s in _spans(prof, tmp_path)] == ["outer"]
    with _recorded():
        @span("decorated.under.a.profiler")
        def later(x):
            return x * 2
    with _recorded() as prof:
        assert later(2) == 4
    assert [s[2] for s in _spans(prof, tmp_path)] == ["decorated.under.a.profiler"]

    def refuse(self):
        raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(profiling._Span, "__enter__", refuse)
    assert later(3) == 6 and work(3) == 4
