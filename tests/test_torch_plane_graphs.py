"""G's plane stage and its CUDA graphs (models/plane_graphs) on the CPU: the
rule that decides to replay, condition by condition; `plane_table` eager,
equal to `plane_stage` bit for bit and counting nothing, on the CPU, under
grad, with random noise and while torch.compiler reports a compile or export
trace; the
key following the stage's tensors; a copied module starting with no graphs.
The replay itself runs on the card (tests/test_torch_cuda_graphs.py)."""

import copy

import pytest
import torch
from torch import nn

from ide3d_tpu_torch.apps.common import PRESETS
from ide3d_tpu_torch.models import plane_graphs
from ide3d_tpu_torch.models.generator import Ide3dGenerator
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(scope="module")
def S():
    return Ide3dGenerator(PRESETS["small"]).init(0).eval().synthesis


def _ws(S, batch=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, S.num_ws, S.cfg.w_dim, generator=g)


ENGAGED = dict(on_cuda=True, grad_enabled=False, noise_mode="const", tracing=False, capturing=False)


@pytest.mark.parametrize("change,want", [
    ({}, True),
    ({"noise_mode": "none"}, True),
    ({"on_cuda": False}, False),
    ({"grad_enabled": True}, False),
    ({"noise_mode": "random"}, False),
    ({"tracing": True}, False),
    ({"capturing": True}, False),
])
def test_engages_each_condition(change, want):
    assert plane_graphs.engages(**dict(ENGAGED, **change)) is want


def _context(case, monkeypatch):
    if case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    if case == "exporting":
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    if case == "inference":
        return torch.inference_mode()
    return torch.enable_grad() if case in ("grad", "random") else torch.no_grad()


@pytest.mark.parametrize("case", ["no_grad", "inference", "grad", "random", "compiling",
                                  "exporting"])
def test_plane_table_stays_eager(S, case, monkeypatch):
    """On the CPU the stage is its eager operations in every case, with the
    same bits as plane_stage, and the counters and the module's graphs stay
    untouched."""
    ws = _ws(S)
    mode, gen = ("random", torch.Generator().manual_seed(3)) if case == "random" else ("const", None)
    plane_graphs.reset_counts()
    with _context(case, monkeypatch):
        got, volume = S.plane_table(ws, mode, gen)
        if gen is not None:
            gen.manual_seed(3)
        want, _ = S.plane_stage(ws, mode, gen)
    assert torch.equal(got, want) and volume is None
    assert plane_graphs.counts() == {"captures": 0, "replays": 0, "eager": 0}
    assert "_plane_graphs" not in S.__dict__


def test_key_follows_the_stage_tensors(S):
    """Another batch, noise mode or inference mode, a swapped tensor, tensors
    made anew by .to(), or a swapped block gives another key; an in-place
    update (Adam, EMA) and other latents keep it."""
    S = copy.deepcopy(S)
    ws = _ws(S)
    with torch.no_grad():
        k0 = plane_graphs.key(S, ws, "const")
        assert plane_graphs.key(S, _ws(S, seed=1), "const") == k0
        assert plane_graphs.key(S, _ws(S, batch=2), "const") != k0
        assert plane_graphs.key(S, ws, "none") != k0
    with torch.inference_mode():
        assert plane_graphs.key(S, ws, "const") != k0
    with torch.no_grad():
        S.vb4.conv.weight.mul_(0.5)
        assert plane_graphs.key(S, ws, "const") == k0
        S.vb4.conv.weight = nn.Parameter(S.vb4.conv.weight.clone())
        k1 = plane_graphs.key(S, ws, "const")
        assert k1 != k0
        S.to(torch.float64)
        k2 = plane_graphs.key(S, ws, "const")
        assert k2 != k1
        S.vb8 = copy.deepcopy(S.vb8)
        assert plane_graphs.key(S, ws, "const") != k2


def test_a_copied_module_starts_with_no_graphs(S):
    """deepcopy (G_ema, a trained copy) gives a fresh Graphs, so a copy never
    replays the graphs of the module it came from."""
    S2 = copy.deepcopy(S)
    S2._plane_graphs = plane_graphs.Graphs()
    S2._plane_graphs.entries["k"] = None
    copied = copy.deepcopy(S2)._plane_graphs
    assert isinstance(copied, plane_graphs.Graphs) and not copied.entries
