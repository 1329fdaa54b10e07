"""G's plane stage replayed from CUDA graphs (models/plane_graphs), on a CUDA
card, at the flagship's widths.

Marked `cuda`; each test skips without a card. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda -q --noconftest

Checked: replayed tables bit-equal to the eager stage at B=8 and B=1 for the
flagship and the reference-compat (two-conv) vb interior; a returned table
unchanged by later calls; a capture again after `.to()`, a swapped parameter
and none after an in-place update; one capture in a 2-clip `render_chunks`
run, every later call replayed; a call under grad eager, with the gradients
of the eager stage.
"""

import numpy as np
import pytest
import torch
from torch import nn

from ide3d_tpu_torch.apps import gen_videos
from ide3d_tpu_torch.models import plane_graphs
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.render.renderer import RenderParams

CONFIGS = {
    "flagship": GeneratorConfig(),
    "ref_compat": GeneratorConfig(vb_ref_compat=True, raw_head="slice"),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


_G = {}


def generator(name: str) -> Ide3dGenerator:
    """The configuration's G on the card, made once a session, its graphs dropped."""
    if name not in _G:
        _G[name] = Ide3dGenerator(CONFIGS[name]).to("cuda").init(0).eval().requires_grad_(False)
    G = _G[name]
    G.synthesis.__dict__.pop("_plane_graphs", None)
    return G


def _ws(G, batch: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(batch, G.num_ws, G.w_dim, device="cuda", generator=g)


def _equal(a: tuple, b: tuple) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("batch", [8, 1])
def test_replay_is_bit_equal_to_eager(name, batch):
    """Eager, capture, replay at one key and a replay of other latents: every
    table equal to the eager stage's bit for bit; one capture, three replays."""
    _card()
    G = generator(name)
    S = G.synthesis
    plane_graphs.reset_counts()
    with torch.inference_mode():
        for seed in (0, 0, 1, 2):
            ws = _ws(G, batch, seed)
            got = S.plane_table(ws)
            assert _equal(got, S.plane_stage(ws)), seed
    assert plane_graphs.counts() == {"captures": 1, "replays": 3, "eager": 1}


@pytest.mark.cuda
def test_returned_table_is_not_overwritten():
    """A table returned by a replay keeps its values through later replays of
    other latents (the Painter keeps its table across calls)."""
    _card()
    G = generator("flagship")
    S = G.synthesis
    with torch.inference_mode():
        S.plane_table(_ws(G, 1, 0))
        S.plane_table(_ws(G, 1, 0))
        table, _ = S.plane_table(_ws(G, 1, 1))
        kept = table.clone()
        other, _ = S.plane_table(_ws(G, 1, 2))
        torch.cuda.synchronize()
    assert plane_graphs.counts()["replays"] >= 2
    assert torch.equal(table, kept) and not torch.equal(table, other)


@pytest.mark.cuda
def test_new_storage_captures_again():
    """`.to()` there and back, and a swapped parameter, give new addresses: a
    new capture, and the replay equal to the eager stage; an in-place update
    keeps the graph, and the replay reads the new values."""
    _card()
    G = Ide3dGenerator(CONFIGS["flagship"]).to("cuda").init(0).eval().requires_grad_(False)
    S = G.synthesis
    ws = _ws(G, 8, 0)

    def replays_equal(expect_captures: int):
        plane_graphs.reset_counts()
        with torch.inference_mode():
            outs = [S.plane_table(ws) for _ in range(3)]
            want = S.plane_stage(ws)
        assert all(_equal(o, want) for o in outs)
        assert plane_graphs.counts()["captures"] == expect_captures
        return want

    before = replays_equal(1)
    held = [t.detach() for t in (*S.parameters(), *S.buffers())]  # no storage is reused
    G.to(torch.float64).to(torch.float32)
    assert _equal(replays_equal(1), before)
    S.vb64.conv.weight = nn.Parameter(S.vb64.conv.weight.detach() * 1.5, requires_grad=False)
    swapped = replays_equal(1)
    assert not _equal(swapped, before)
    with torch.no_grad():
        S.vb64.conv.weight.mul_(1 / 1.5)
    plane_graphs.reset_counts()
    with torch.inference_mode():
        got = S.plane_table(ws)
        assert _equal(got, S.plane_stage(ws))
    assert plane_graphs.counts() == {"captures": 0, "replays": 1, "eager": 0}
    del held


@pytest.mark.cuda
def test_render_chunks_captures_once():
    """Two 64-frame clips through gen_videos.render_chunks in chunks of 8, as
    the video cells run them: one eager call, one capture, 15 replays."""
    _card()
    G = generator("flagship")
    rng = np.random.default_rng(0)
    cs = np.stack([gen_videos.orbit_label(fi, 64) for fi in range(64)])
    rp = RenderParams(img_size=G.cfg.render_size, num_steps=96, hierarchical=True)
    plane_graphs.reset_counts()
    for _ in range(2):
        ws = rng.standard_normal((64, G.num_ws, G.w_dim)).astype(np.float32)
        tiles = gen_videos.render_chunks(G, ws, cs, rp, "image_seg", 8, "cuda")
        assert len(tiles) == 64
    assert plane_graphs.counts() == {"captures": 1, "replays": 15, "eager": 1}


@pytest.mark.cuda
def test_grad_call_is_eager_with_the_same_gradients():
    """Under grad, after graphs were captured, the stage runs eager: no replay,
    and the gradients of the eager stage bit for bit (cuDNN's deterministic
    algorithms, so that two eager passes agree)."""
    _card()
    G = generator("flagship")
    S = G.synthesis
    ws = _ws(G, 1, 0)
    with torch.inference_mode():
        for _ in range(3):
            S.plane_table(ws)
    plane_graphs.reset_counts()
    grads = []
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        for fn in (S.plane_table, S.plane_stage):
            x = ws.clone().requires_grad_(True)
            table, _ = fn(x)
            (g,) = torch.autograd.grad(table.float().square().mean(), x)
            grads.append(g)
    assert torch.equal(grads[0], grads[1])
    assert plane_graphs.counts() == {"captures": 0, "replays": 0, "eager": 1}
