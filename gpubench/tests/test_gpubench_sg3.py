"""The SG3 cell's pieces on the CPU: the `video_sg3` kind at the tiny sizes
(the reference following the program in float32, the fp8 control and a
planted fault not correct), its counts (counts/sg3.py against
torch.utils.flop_counter on the reference at the configuration's sizes, on
meta tensors) and its three readers on hand-built traces."""

import copy
import json
import os
import time
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import harness
from gpubench.counts import flops
from gpubench.counts import sg3 as counts
from gpubench.reference import generator as ref
from gpubench.reference import sg3
from gpubench.tests.tiny import GENERATOR, ROOT, TRAFFIC
from gpubench.trace import TraceStats

CELL = "video.ide3d-ffhq512-sg3"


def tiny_run(seed: int = 2**31 + 7, dtype: str = "bfloat16", trace: bool = False) -> harness.Run:
    torch.set_num_threads(2)
    run = harness.make_run(ROOT, CELL, seed, 0.3, trace, "cpu", time.perf_counter())
    run.traffic.update(TRAFFIC["video"])
    run.config["generator"].update(GENERATOR, dtype=dtype)
    return run


def config() -> dict:
    with open(os.path.join(ROOT, "gpubench", "configs", "ide3d-ffhq512-sg3.json")) as f:
        return json.load(f)


def test_the_reference_follows_the_program_in_float32():
    result = harness.run_cell(tiny_run(dtype="float32"))
    assert result["correct"] and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(c["value"] < 0.01 for c in result["checks"].values()), result["checks"]


def test_the_lower_precision_control_is_not_correct():
    run = tiny_run()
    run.control = True
    result = harness.run_cell(run)
    control = result["control"]
    assert any(control["control.lower." + k] > c["limit"] for k, c in result["checks"].items()), control


def test_an_altered_answer_is_not_correct(monkeypatch):
    from ide3d_tpu_torch.apps import gen_videos

    post = gen_videos.post
    monkeypatch.setattr(gen_videos, "post", lambda out, image_mode, R: (255 - post(out, image_mode, R)[0],
                                                                          post(out, image_mode, R)[1]))
    assert not harness.run_cell(tiny_run(dtype="float32"))["correct"]


def test_finish_reports_the_sg3_frame_flops():
    from gpubench.kinds import video_sg3

    run = tiny_run()
    st = types.SimpleNamespace(frames=24, chunk=8)
    out = video_sg3.finish(st, run, types.SimpleNamespace(snapshot={"frames": 16}, seconds=2.0))
    assert out["e2e"] == {"frames_per_s": 8.0}
    assert out["work"] == {"flops": 16 * counts.frame_flops(run.config), "k1_batch": 8, "sg3_batch": 8}
    assert "g_frames" not in out["work"]  # counts/flops.py's frame is the SG2 superres G's


def _direct_fir_flops(spec: dict, B: int) -> int:
    """The reference's FIR FLOPs as flop_counter counts them: each 1-D pass a
    depthwise convolution over the zero-stuffed, padded grid."""
    n = spec["in_size"] + spec["k"] - 1
    px0, px1 = spec["padding"][:2]
    tu, td = spec["up_taps"], spec["down_taps"]
    p = n * spec["up"] + px0 + px1
    u = p - tu + 1
    d = u - td + 1
    total = 0
    if tu > 1:
        total += p * u * tu + u * u * tu
    if td > 1:
        total += u * d * td + d * d * td
    return 2 * B * spec["cout"] * total


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_stack_flops_against_flop_counter_at_the_configuration_sizes():
    """On meta tensors at the flagship's widths (B=1): flop_counter over the
    reference's SG3 stack is counts.stack_flops plus the reference's direct
    FIR; generator_frame less flop_counter over the reference's SG2 superres
    (raw head included) is counts' shared part less the raw head."""
    cfg = config()
    arch = ref.Arch(cfg["generator"])
    specs = sg3.layer_specs(arch)
    shapes = {}
    for s in specs:
        shapes[s["name"] + ".weight"] = (s["cout"], s["cin"], s["k"], s["k"])
        shapes[s["name"] + ".bias"] = (s["cout"],)
        shapes[s["name"] + ".affine.weight"] = (s["cin"], cfg["generator"]["w_dim"])
        shapes[s["name"] + ".affine.bias"] = (s["cin"],)
        shapes[s["name"] + ".magnitude_ema"] = ()
    P = {k: torch.ones(v, device="meta") for k, v in shapes.items()}
    ws = torch.ones(1, arch.num_ws, cfg["generator"]["w_dim"], device="meta")
    feat = torch.ones(1, arch.fc, arch.g["render_size"], arch.g["render_size"], device="meta")
    got = _counted(lambda: sg3.superres(P, arch, feat, ws, ref.exact, specs))
    assert got == counts.stack_flops(cfg) + sum(_direct_fir_flops(s, 1) for s in specs)

    sg2 = copy.deepcopy(cfg)
    sg2["generator"]["sr_arch"] = "sg2"
    P2 = {}
    for i, res in enumerate(arch.sr_res):
        cin = arch.fc if i == 0 else min(arch.g["sr_channel_base"] // arch.sr_res[i - 1],
                                          arch.g["sr_channel_max"])
        cout = min(arch.g["sr_channel_base"] // res, arch.g["sr_channel_max"])
        for name, ci, co, k in (("conv0", cin, cout, 3), ("conv1", cout, cout, 3), ("torgb", cout, 3, 1)):
            n = f"synthesis.b{res}.{name}"
            P2.update({n + ".weight": (co, ci, k, k), n + ".bias": (co,), n + ".affine.weight": (ci, 512),
                       n + ".affine.bias": (ci,), n + ".noise_const": (res, res), n + ".noise_strength": ()})
    P2["synthesis.raw_rgb.weight"], P2["synthesis.raw_rgb.bias"] = (3, arch.fc, 1, 1), (3,)
    P2["synthesis.raw_rgb.affine.weight"], P2["synthesis.raw_rgb.affine.bias"] = (arch.fc, 512), (arch.fc,)
    P2 = {k: torch.ones(v, device="meta") for k, v in P2.items()}
    sg2_superres = _counted(lambda: ref.superres(P2, arch, feat, ws, ref.exact))
    raw_head = _counted(lambda: ref.torgb(P2, "synthesis.raw_rgb", feat, ws[:, 0], ref.exact))
    shared = flops.generator_frame(sg2) - sg2_superres + raw_head  # vb stack, decoder, raw head
    assert shared == counts.frame_flops(cfg) - counts.stack_flops(cfg)


def test_bytes_counts_at_the_flagship():
    cfg = config()
    per_call = counts.launch_bytes(cfg, 8)
    assert len(per_call) == 9
    # layer6: a [8, 32, 514, 514] bf16 conv output in, [8, 32, 512, 512] out, the bias, 24 fp32 taps
    assert per_call[6] == 8 * 32 * (514 * 514 + 512 * 512) * 2 + 32 * 2 + 24 * 4
    assert per_call[8] == 8 * 3 * 2 * 512 * 512 * 2 + 3 * 2  # the ToRGB: no filters
    assert abs(sum(per_call) / 1e9 - 1.097) < 0.001
    assert abs(counts.stack_flops(cfg) / 1e9 - 27.84) < 0.01


def ev(name: str, start_ms: float, dur_ms: float, cat: str = "user_annotation") -> dict:
    return {"ph": "X", "cat": cat, "name": name, "ts": start_ms * 1e3, "dur": dur_ms * 1e3}


KERNEL_22 = "void (anonymous namespace)::filtered_lrelu_kernel<2, 2, 12, 12, __nv_bfloat16>(int)"
KERNEL_ACT = "void (anonymous namespace)::filtered_lrelu_act_kernel<__nv_bfloat16>(int)"


def sg3_trace(fused_per_stack: int, with_sg3: bool = True) -> list:
    """Two chunks, each: G.finish holding G.sg3 (4 / 6 ms), `fused_per_stack`
    kernel launches of 0.1 ms inside it (the last the act kernel)."""
    out = []
    for t, ms in ((0.0, 4.0), (50.0, 6.0)):
        out += [ev("video.chunk", t, 40.0), ev("G.finish", t + 10.0, 20.0)]
        if with_sg3:
            out.append(ev("G.sg3", t + 11.0, ms))
        for i in range(fused_per_stack):
            out.append(ev(KERNEL_ACT if i == fused_per_stack - 1 else KERNEL_22, t + 11.0 + 0.2 * i, 0.1,
                          "kernel"))
    return out


def read(metric: str, events: list, device: str = "cuda", batch: int = 8):
    import importlib

    reader = importlib.import_module(f"gpubench.layers.{metric.split('.')[0]}")
    ctx = {"run": types.SimpleNamespace(device=device, config=config()),
           "trace": TraceStats.from_events(events), "win": None, "work": {"sg3_batch": batch},
           "state": None}
    return reader.read(metric, ctx)


def test_sg3_ms_reads_the_spans_per_chunk():
    assert read("sg3_ms.video", sg3_trace(9)) == 5.0


@pytest.mark.parametrize("fused,want", [(9, 1.0), (8, 8 / 9), (0, 0.0)])
def test_fused_share_counts_launches_per_stack_call(fused, want):
    assert read("flrelu_fused_share.video", sg3_trace(fused)) == pytest.approx(want)


def test_flrelu_roofline_is_the_bytes_bound_over_the_kernel_time():
    per_call = counts.launch_bytes(config(), 8)
    want = 100 * (2 * sum(per_call) / 3.35e12) / (18 * 0.1e-3)
    assert read("flrelu_roofline.video", sg3_trace(9)) == pytest.approx(want)


@pytest.mark.parametrize("fused", [8, 1])
def test_flrelu_roofline_reads_nothing_where_a_stack_call_ran_plain(fused):
    """The bytes are the whole stacks': with fewer launches than calls they
    would overstate the launches' own bytes."""
    assert read("flrelu_roofline.video", sg3_trace(fused)) is None


@pytest.mark.parametrize("metric", ["sg3_ms.video", "flrelu_fused_share.video", "flrelu_roofline.video"])
def test_readers_read_nothing_without_the_span_or_the_kernel(metric):
    """The parent's trace: no `G.sg3` span and no fused launch; and the CPU."""
    assert read(metric, sg3_trace(0, with_sg3=False)) is None
    assert read(metric, sg3_trace(9), device="cpu") is None
