"""The port's alias-free (SG3) superres G against its plain float32
reference, gpubench/reference/sg3.py, on the CPU.

At the tiny widths of tests/test_torch_arch.py, on the same weights drawn by
the benchmark's `init` rules of gpubench/configs/ide3d-ffhq512-sg3.json:
  * the whole frame within 2e-4 x max(1, max|ref|), the golden test's
    tolerance: the render's composite sums in another order in the port's
    plain K1 than in the reference (read: 5.7e-5 at a max of 20);
  * the superres stack alone on the same feature image within 1e-5 x max|ref|:
    the same sums of the same products, in the order the port's plain
    upfirdn2d and the reference's zero-insert filters each take (read: under
    1e-7 of the max), so each layer is held to its own arithmetic;
  * two planted faults in the port fail that comparison: the clamp left out
    and magnitude_ema ignored (each layer's EMA drawn in [0.25, 4], the
    feature image 300x, so that the clamp engages).
At the flagship's widths, the reference's schedule and filters (scipy's
Kaiser design) against the port's layers: factors, padding and taps. And
filtered_lrelu's dispatch on the CPU: the plain op, counted, no launch. The
card path's autograd Function, with the plain op standing in for the launch
(the kernel runs only on a card): its recomputing backward passes gradcheck
and gradgradcheck in float64. torch.export on the CPU records the op as one
node of the operator, which runs the plain op. The G.sg3 span lies inside
G.finish in a profiled frame.
"""

import json
import os

import numpy as np
import pytest
import torch

from gpubench import weights
from gpubench.kinds.common import look_at_label
from gpubench.reference import generator as ref
from gpubench.reference import sg3
from ide3d_tpu_torch.models import layers_sg3
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.ops import filtered_lrelu as flrelu_mod
from ide3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "gpubench", "configs", "ide3d-ffhq512-sg3.json")
TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
FRAME_TOL = 2e-4
STACK_TOL = 1e-5


def _config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def _generator_section(tiny: bool) -> dict:
    g = dict(_config()["generator"])
    if tiny:
        g.update(TINY, render=dict(g["render"], img_size=8, num_steps=4))
    return g


def _port_config(g: dict) -> GeneratorConfig:
    rp = dict(g["render"], pixel_offset=tuple(g["render"]["pixel_offset"]))
    return GeneratorConfig(**dict(g, render=RenderParams(**rp)))


@pytest.fixture(scope="module")
def tiny():
    """(the port's tiny SG3 G, its state drawn by the configuration's rules,
    the reference's sizes)."""
    g = _generator_section(tiny=True)
    G = Ide3dGenerator(_port_config(g)).eval().requires_grad_(False)
    shapes = {k: tuple(v.shape) for k, v in G.state_dict().items()}
    state = weights.draw_state(shapes, _config()["init"], 2**31 + 5, "cpu")
    G.load_state_dict(state)
    return G, state, ref.Arch(g)


def _latents(G, seed: int = 0):
    rng = np.random.default_rng(seed)
    ws = torch.tensor(rng.normal(size=(2, G.num_ws, G.w_dim)), dtype=torch.float32)
    c = torch.tensor(np.stack([look_at_label(0.3, 0.1), look_at_label(-0.2, 0.0)]))
    return ws, c, rng


def _close(got, want, tol, scale=None):
    scale = float(want.abs().max()) if scale is None else scale
    err = float((got - want).abs().max())
    return err <= tol * scale, (err, scale)


def test_config_draws_every_state_entry(tiny):
    """The configuration's init rules match every entry of the SG3 G's state
    (draw_state raises on one they miss), magnitude_ema at 1."""
    _, state, arch = tiny
    emas = [k for k in state if k.endswith(".magnitude_ema")]
    assert len(emas) == 2 * len(arch.sr_res) + 1 and all(float(state[k]) == 1.0 for k in emas)


def test_frame_matches_reference(tiny):
    G, state, arch = tiny
    ws, c, _ = _latents(G)
    with torch.no_grad():
        img, seg = G.synthesis(ws, c, return_seg=True)
    want = sg3.frame(ref.load_params(state, "cpu"), arch, ws, c)
    for name, got in (("img", img), ("seg", seg)):
        ok, info = _close(got, want[name], FRAME_TOL, max(1.0, float(want[name].abs().max())))
        assert ok, (name, info)


def _stack_inputs(G, state, rng):
    """Each layer's magnitude_ema drawn in [0.25, 4] and a 300x feature image."""
    state = dict(state)
    for k in state:
        if k.endswith(".magnitude_ema"):
            state[k] = torch.tensor(float(rng.uniform(0.25, 4.0)))
    G.load_state_dict(state)
    feat = 300 * torch.tensor(rng.normal(size=(2, G.cfg.feature_channels, 8, 8)), dtype=torch.float32)
    return state, feat


def _no_clamp(monkeypatch):
    monkeypatch.setattr(layers_sg3, "CONV_CLAMP", None)


def _ema_ignored(monkeypatch):
    forward = layers_sg3.SynthesisLayer3.forward

    def ignoring(self, x, w):
        saved = self.magnitude_ema.detach().clone()
        with torch.no_grad():
            self.magnitude_ema.fill_(1.0)
        try:
            return forward(self, x, w)
        finally:
            with torch.no_grad():
                self.magnitude_ema.copy_(saved)

    monkeypatch.setattr(layers_sg3.SynthesisLayer3, "forward", ignoring)


@pytest.mark.parametrize("fault", [None, _no_clamp, _ema_ignored], ids=["sound", "clamp-left-out",
                                                                        "magnitude-ema-ignored"])
def test_stack_matches_reference_and_planted_faults_fail(tiny, fault, monkeypatch):
    G, state, arch = tiny
    ws, _, rng = _latents(G, 1)
    varied, feat = _stack_inputs(G, state, rng)
    try:
        want = sg3.superres(ref.load_params(varied, "cpu"), arch, feat, ws, ref.exact)
        if fault is not None:
            fault(monkeypatch)
        with torch.no_grad():
            got = G.synthesis.superresolve(feat, None, ws)
        ok, info = _close(got, want, STACK_TOL)
        assert ok == (fault is None), info
    finally:
        monkeypatch.undo()
        G.load_state_dict(state)


def test_reference_schedule_and_filters_match_the_port_at_flagship_width():
    g = _generator_section(tiny=False)
    stack = Ide3dGenerator(_port_config(g)).synthesis.sg3_sr
    specs = sg3.layer_specs(ref.Arch(g))
    layers = [getattr(stack, f"layer{i}") for i in range(stack.num_layers)] + [stack.torgb]
    assert len(specs) == len(layers) == 9
    for spec, layer in zip(specs, layers):
        assert (spec["up"], spec["down"]) == (layer.up_factor, layer.down_factor), spec["name"]
        assert spec["padding"] == layer.padding, spec["name"]
        assert tuple(layer.weight.shape) == (spec["cout"], spec["cin"], spec["k"], spec["k"])
        for ours, theirs in ((spec["fu"], layer.up_filter), (spec["fd"], layer.down_filter)):
            assert (ours is None) == (theirs is None), spec["name"]
            if ours is not None:
                assert np.array_equal(ours, theirs.numpy()), spec["name"]
    assert [s["cout"] for s in specs[:-1]] == [256, 128, 128, 64, 64, 32, 32, 32]
    assert [(s["up"], s["down"]) for s in specs] == [(2, 2), (4, 2)] * 3 + [(2, 2)] * 2 + [(1, 1)]


def test_dispatch_on_the_cpu_runs_the_plain_op():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(2, 3, 12, 12)), dtype=torch.float32)
    fu = torch.tensor(layers_sg3.design_lowpass_filter(12, 5.0, 2.5, 32.0))
    b = torch.tensor(rng.normal(size=3), dtype=torch.float32)
    kw = dict(fu=fu, fd=fu, b=b, up=2, down=2, padding=(9, 8, 9, 8), clamp=256.0)
    filtered_lrelu.launches = filtered_lrelu.plain = 0
    with torch.no_grad():
        got = filtered_lrelu(x, **kw)
    assert (filtered_lrelu.launches, filtered_lrelu.plain) == (0, 1)
    assert torch.equal(got, filtered_lrelu_plain(x, **kw))


def _flrelu_inputs(dtype, up=2, down=2):
    """x, b and filters of 6 taps a factor, as the SG3 layers design them."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(1, 3, 6, 6)), dtype=dtype)
    fu, fd = [torch.tensor(layers_sg3.design_lowpass_filter(6 * k, 5.0, 2.5, 16.0 * k), dtype=dtype)
              for k in (up, down)]
    b = torch.tensor(rng.normal(size=3), dtype=dtype)
    return x, fu, fd, b


@pytest.mark.parametrize("up,down,padding", [(2, 2, (7, 6, 7, 6)), (4, 2, (20, 19, 20, 19))])
def test_card_function_backward_recomputes_plain(monkeypatch, up, down, padding):
    """_FilteredLreluFn with the plain op as its launch: the backward's
    recompute gives the plain op's first and second derivatives."""
    monkeypatch.setattr(flrelu_mod, "_launch", lambda x, fu, fd, b, *args: filtered_lrelu_plain(
        x, fu, fd, b, *args))
    x, fu, fd, b = _flrelu_inputs(torch.float64, up, down)

    def op(x, b):
        return flrelu_mod._FilteredLreluFn.apply(x, fu, fd, b, up, down, padding, 2**0.5, 0.2,
                                                 256.0, False)

    inputs = (x.requires_grad_(), b.requires_grad_())
    with torch.enable_grad():  # some test modules turn autograd off when a worker imports them
        assert torch.autograd.gradcheck(op, inputs, fast_mode=True)
        assert torch.autograd.gradgradcheck(op, inputs, fast_mode=True)


def test_export_records_the_operator_on_the_cpu():
    x, fu, fd, b = _flrelu_inputs(torch.float32)
    kw = dict(up=2, down=2, padding=(7, 6, 7, 6), clamp=256.0)

    class Layer(torch.nn.Module):
        def forward(self, x, b):
            return filtered_lrelu(x, fu, fd, b, **kw)

    program = torch.export.export(Layer(), (x, b))
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(flrelu_mod.OP) == 1
    assert not any("conv" in str(t) for t in ops)
    filtered_lrelu.launches = 0
    assert torch.equal(program.module()(x, b), filtered_lrelu_plain(x, fu, fu, b, **kw))
    assert filtered_lrelu.launches == 0


def test_sg3_span_inside_finish(tiny, tmp_path):
    G, _, _ = tiny
    ws, c, _ = _latents(G)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            G.synthesis(ws, c)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                 for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    finish = [s for s in spans if s[2] == "G.finish"]
    inner = [s for s in spans if s[2] == "G.sg3"]
    assert len(finish) == len(inner) == 1
    assert finish[0][0] <= inner[0][0] and inner[0][1] <= finish[0][1]
