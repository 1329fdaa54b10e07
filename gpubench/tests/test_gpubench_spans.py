"""The span metrics' readers (layers/_spans.py and its callers) on hand-built
traces: nested program spans among aten operations, kernels and the idle gaps
between them, each reader's exact value, and parents found however many host
events lie between a span and its parent."""

import importlib
import types

import pytest

from gpubench.trace import TraceStats
from gpubench.layers import _spans


def ev(name: str, start_ms: float, dur_ms: float, cat: str = "user_annotation") -> dict:
    return {"ph": "X", "cat": cat, "name": name, "ts": start_ms * 1e3, "dur": dur_ms * 1e3}


def read(metric: str, events: list, device: str = "cuda"):
    reader = importlib.import_module(f"gpubench.layers.{metric.split('.')[0]}")
    ctx = {"run": types.SimpleNamespace(device=device), "trace": TraceStats.from_events(events),
           "win": None, "work": {}, "state": None}
    return reader.read(metric, ctx)


def frame(t: float, planes: float, render: float, finish: float) -> list:
    """One G pass from t: its three stages back to back, an aten op and a
    kernel in each."""
    out = []
    for name, dur in (("G.planes", planes), ("G.render", render), ("G.finish", finish)):
        out += [ev(name, t, dur), ev("aten::conv2d", t + 0.25, 0.5, "cpu_op"),
                ev("some_kernel", t + 0.5, dur / 2, "kernel")]
        t += dur
    return out


def video_trace() -> list:
    """Two chunks (planes 10 / 12 ms, render 5, finish 8), each followed by its
    wait (1 / 3 ms) and tiles; one idle gap under no span."""
    out = []
    for t, planes, wait in ((0.0, 10.0, 1.0), (40.0, 12.0, 3.0)):
        out += [ev("video.chunk", t, 30.0)] + frame(t + 1.0, planes, 5.0, 8.0)
        out += [ev("video.wait", t + 30.0, wait), ev("cudaEventSynchronize", t + 30.0, wait, "cpu_op"),
                ev("video.tiles", t + 30.0 + wait, 2.0)]
    return out


@pytest.mark.parametrize("metric,want", [("planes_ms.video", 11.0), ("render_ms.video", 5.0),
                                         ("finish_ms.video", 8.0), ("wait_ms.video", 2.0)])
def test_video_readers(metric, want):
    assert read(metric, video_trace()) == want


def painter_trace() -> list:
    """Eight edit requests, 4 strokes a view from the second stroke of a view:
    requests 2 and 6 uncached (two G passes), the others one. Request i: edit
    20 + i ms inside a 50 + 2 i ms request, PNG 10 + i ms in two encodes,
    to_host 3 + i ms."""
    out, t = [], 0.0
    for i in range(8):
        edit, request, png, to_host = 20.0 + i, 50.0 + 2 * i, 10.0 + i, 3.0 + i
        out += [ev("web.request", t, request), ev("aten::empty", t + 0.5, 0.25, "cpu_op"),
                ev("painter.edit", t + 1.0, edit)]
        passes = 2 if i in (2, 6) else 1
        u = t + 1.5
        for p in range(passes):
            if p == passes - 1:
                out.append(ev("painter.encode", u, 1.0))
                u += 1.0
            out += frame(u, 1.0, 1.0, 1.0)
            u += 3.0
        out.append(ev("painter.to_host", t + 1.0 + edit - to_host, to_host))
        out += [ev("web.png", t + 2.0 + edit, png / 2), ev("web.png", t + 2.0 + edit + png / 2, png / 2)]
        t += request + 5.0
    return out


@pytest.mark.parametrize("metric,want", [
    ("edit_span_ms.painter", 23.5),  # the median of 20..27
    ("server_span_ms.painter", 33.5),  # request less edit: 30 + i
    ("png_ms.painter", 13.5),
    ("to_host_ms.painter", 6.5),
    ("g_passes.painter", 1.25),  # (2 x 2 + 6 x 1) / 8
])
def test_painter_readers(metric, want):
    assert read(metric, painter_trace()) == pytest.approx(want, abs=1e-9)


def step_trace(between: int = 0) -> list:
    """Three steps: plain (400 ms: G 150, D 200), R1 (600: G 150, D 400 with
    R1 250) and plain (420: G 160, D 220); `between` aten operations in the R1
    step's D phase before its R1 span."""
    out, t = [], 0.0
    for dur, g, d, r1 in ((400.0, 150.0, 200.0, 0.0), (600.0, 150.0, 400.0, 250.0),
                          (420.0, 160.0, 220.0, 0.0)):
        out += [ev("gan.step", t, dur), ev("gan.g_phase", t + 1.0, g),
                ev("gan.d_phase", t + 2.0 + g, d), ev("k", t + 5.0, g / 2, "kernel")]
        if r1:
            u = t + 2.0 + g
            for k in range(between):
                out.append(ev("aten::mul", u + 0.01 * k, 0.005, "cpu_op"))
            out.append(ev("gan.r1", t + 2.0 + g + d - r1 - 1.0, r1))
        t += dur + 1.0
    return out


@pytest.mark.parametrize("metric,want", [("step_span_ms.train", 410.0), ("r1_step_span_ms.train", 600.0),
                                         ("g_phase_ms.train", 155.0), ("d_phase_ms.train", 210.0)])
def test_train_readers(metric, want):
    assert read(metric, step_trace()) == pytest.approx(want, abs=1e-9)


def test_a_parent_more_than_400_host_events_earlier_is_found():
    events = step_trace(between=1000)
    stats = TraceStats.from_events(events)
    found = _spans.spans(stats)
    (r1,) = _spans.named(found, "gan.r1")
    assert r1.parent.name == "gan.d_phase" and r1.parent.parent.name == "gan.step"
    # the breakdown's lookback of 400 host events loses the D phase before R1
    assert stats.host_op_at(r1.start - 1e3) == "no host op"
    step_start = r1.parent.parent.start
    assert sum(1 for h in stats.host if step_start <= h[0] < r1.start) > 400
    assert read("r1_step_span_ms.train", events) == pytest.approx(600.0)
    assert read("step_span_ms.train", events) == pytest.approx(410.0)


def test_spans_of_other_names_are_left_out_and_parents_come_by_containment():
    events = video_trace() + [ev("frame", -1.0, 100.0), ev("ProfilerStep#1", -1.0, 100.0)]
    found = _spans.spans(TraceStats.from_events(events))
    assert {s.name for s in found} <= _spans.NAMES
    chunks = _spans.named(found, "video.chunk")
    assert [s.parent for s in chunks] == [None, None]
    assert all(s.parent is chunks[0] for s in found if s.name.startswith("G.") and s.start < 40e3)
    assert all(s.parent is None for s in _spans.named(found, "video.wait"))


@pytest.mark.parametrize("metric", ["planes_ms.video", "render_ms.video", "finish_ms.video",
                                    "wait_ms.video", "edit_span_ms.painter",
                                    "server_span_ms.painter", "png_ms.painter",
                                    "to_host_ms.painter", "g_passes.painter",
                                    "step_span_ms.train", "r1_step_span_ms.train",
                                    "g_phase_ms.train", "d_phase_ms.train"])
def test_readers_report_nothing_off_cuda_or_without_their_spans(metric):
    every = video_trace() + painter_trace() + step_trace()
    assert read(metric, every, device="cpu") is None
    assert read(metric, [ev("k", 0.0, 1.0, "kernel"), ev("aten::add", 0.0, 1.0, "cpu_op")]) is None
