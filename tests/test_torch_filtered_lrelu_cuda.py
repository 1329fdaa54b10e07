"""The fused filtered_lrelu kernel (csrc/filtered_lrelu.cu) against the plain
op (ops/filtered_lrelu.filtered_lrelu_plain) on a CUDA card.

Marked `cuda`; each test skips without a card. The file imports no JAX:

    python -m pytest tests/test_torch_filtered_lrelu_cuda.py -m cuda -q --noconftest

The inputs are the SG3 superres stack's own: its 9 calls (8 layers and the
ToRGB) recorded from a pass of the flagship-width stack, at B = 1 and 8.
Tolerances:
  * fp32: within 1e-5 of max|out|. Both sum in fp32 with TF32 off; they
    differ in the order of the sums (the kernel's polyphase taps skip the
    inserted zeros) by a few ulps of the partial sums;
  * bf16: both take the same bf16 input and are held against the fp32 plain
    op on it. The plain bf16 op rounds to bf16 after the bias, each of its
    four filter passes and the activation, with bf16 taps; the kernel sums in
    fp32 and rounds once. So its error is to be no larger than the plain
    path's plus one bf16 rounding of max|out| (2^-8 of it), the rounding its
    own output takes.
Also: the clamp and flip_filter; the card never runs the plain op: under
autograd the kernel runs forward and the backward's recompute gives the plain
op's first and second derivatives, a call the kernel does not take (a radial
filter, a factor of 3, float16) raises, and an exported program launches the
kernel; 9 launches a frame of the SG3 G, with and without gradients.
"""

import numpy as np
import pytest
import torch

from ide3d_tpu_torch.models import layers_sg3
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.models.layers import init_seeded
from ide3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_plain

NAMES = [f"layer{i}" for i in range(8)] + ["torgb"]
FP32_TOL = 1e-5
BF16_ROUNDING = 2.0**-8


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


_CALLS = {}


def _calls() -> list:
    """The stack's 9 filtered_lrelu calls at B = 8, fp32: (x, kwargs), each x
    what the previous layers made from a random feature image."""
    if not _CALLS:
        stack = Ide3dGenerator(GeneratorConfig(sr_arch="sg3")).synthesis.sg3_sr
        stack = init_seeded(stack, 0).to("cuda").eval().requires_grad_(False)
        calls = []

        def record(x, fu, fd, b, **kw):
            calls.append((x.clone(), dict(kw, fu=fu, fd=fd, b=b)))
            return filtered_lrelu_plain(x, fu, fd, b, **kw)

        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(8, stack.layer0.in_channels, 64, 64, device="cuda", generator=g)
        ws = torch.randn(8, 9, 512, device="cuda", generator=g)
        saved = layers_sg3.filtered_lrelu
        layers_sg3.filtered_lrelu = record
        try:
            with torch.no_grad():
                for i in range(8):
                    x = getattr(stack, f"layer{i}")(x, ws[:, i])
                stack.torgb(x, ws[:, 8])
        finally:
            layers_sg3.filtered_lrelu = saved
        for name, (x, kw) in zip(NAMES, calls):
            g = torch.Generator(device="cuda").manual_seed(len(_CALLS) + 1)
            kw["b"] = torch.randn(x.shape[1], device="cuda", generator=g)  # a bias that moves it
            _CALLS[name] = (x, kw)
    return [_CALLS[n] for n in NAMES]


def _call(name: str, batch: int, dtype) -> tuple:
    x, kw = dict(zip(NAMES, _calls()))[name]
    return x[:batch].to(dtype), dict(kw, b=kw["b"].to(dtype))


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_fp32(name, batch):
    _card()
    x, kw = _call(name, batch, torch.float32)
    filtered_lrelu.launches = filtered_lrelu.plain = 0
    with torch.no_grad():
        got = filtered_lrelu(x, **kw)
    want = filtered_lrelu_plain(x, **kw)
    assert (filtered_lrelu.launches, filtered_lrelu.plain) == (1, 0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = float(want.abs().max())
    assert _max_err(got, want) <= FP32_TOL * scale, (name, _max_err(got, want), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_bf16_no_worse_than_plain_bf16(name, batch):
    _card()
    x, kw = _call(name, batch, torch.bfloat16)
    with torch.no_grad():
        got = filtered_lrelu(x, **kw)
        plain = filtered_lrelu_plain(x, **kw)
        exact = filtered_lrelu_plain(x.float(), **dict(kw, b=kw["b"].float()))
    assert got.dtype == torch.bfloat16 and got.shape == exact.shape
    scale = float(exact.abs().max())
    err, err_plain = _max_err(got, exact), _max_err(plain, exact)
    assert err <= err_plain + BF16_ROUNDING * scale, (name, err, err_plain, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["layer1", "layer6", "torgb"])
def test_clamp_engages(name):
    """Inputs 300x the stack's: many outputs at +-256 in both."""
    _card()
    x, kw = _call(name, 1, torch.float32)
    with torch.no_grad():
        got = filtered_lrelu(x * 300, **kw)
    want = filtered_lrelu_plain(x * 300, **kw)
    assert float((want.abs() >= 255.9).float().mean()) > 0.01
    assert _max_err(got, want) <= FP32_TOL * 256


@pytest.mark.cuda
@pytest.mark.parametrize("up,down,padding,flip", [
    (2, 2, (3, -2, 5, 1), True), (4, 1, (20, 11, 7, 13), False), (1, 2, (2, 3, 4, 1), True),
    (2, 1, 0, False)])
def test_other_factors_padding_and_flip(up, down, padding, flip):
    """Covered calls that the stack does not make: other factor pairs, negative
    (cropping) and uneven padding, flip_filter, odd sizes."""
    _card()
    rng = np.random.default_rng(up * 10 + down)
    fu = torch.tensor(rng.normal(size=6 * up), dtype=torch.float32, device="cuda")
    fd = torch.tensor(rng.normal(size=6 * down), dtype=torch.float32, device="cuda")
    x = torch.tensor(rng.normal(size=(3, 5, 37, 29)), dtype=torch.float32, device="cuda")
    b = torch.tensor(rng.normal(size=5), dtype=torch.float32, device="cuda")
    kw = dict(fu=fu, fd=fd, b=b, up=up, down=down, padding=padding, gain=1.3, slope=0.1,
              clamp=2.0, flip_filter=flip)
    filtered_lrelu.launches = 0
    with torch.no_grad():
        got = filtered_lrelu(x, **kw)
    want = filtered_lrelu_plain(x, **kw)
    assert filtered_lrelu.launches == 1 and got.shape == want.shape
    assert _max_err(got, want) <= FP32_TOL * float(want.abs().max())


@pytest.mark.cuda
def test_autograd_runs_the_kernel():
    """The kernel forward; x's and b's gradients, and a create_graph pass's
    second derivative, as the plain op's under autograd."""
    _card()
    x, kw = _call("layer0", 1, torch.float32)
    grads = []
    for op in (filtered_lrelu, filtered_lrelu_plain):
        xg, bg = x.clone().requires_grad_(), kw["b"].clone().requires_grad_()
        filtered_lrelu.launches = filtered_lrelu.plain = 0
        y = op(xg, **dict(kw, b=bg))
        counts = (filtered_lrelu.launches, filtered_lrelu.plain)
        gx, gb = torch.autograd.grad(y.square().sum(), (xg, bg), create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum() + gb.sum(), (xg,))
        grads.append((y, gx, gb, ggx))
        if op is filtered_lrelu:
            assert counts == (1, 0)
    for got, want in zip(*grads):
        got, want = got.detach(), want.detach()
        scale = float(want.abs().max())
        assert scale > 0 and _max_err(got, want) <= FP32_TOL * scale, (_max_err(got, want), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["radial", "up3", "float16"])
def test_uncovered_calls_raise_on_the_card(case):
    _card()
    x, kw = _call("layer0", 1, torch.float32)
    if case == "radial":
        radial = layers_sg3.design_lowpass_filter(12, 25.6, 12.8, 128.0, radial=True)
        kw = dict(kw, fd=torch.from_numpy(radial).cuda())
    elif case == "up3":
        kw = dict(kw, up=3, fu=torch.ones(18, device="cuda"))
    else:
        x, kw = x.half(), dict(kw, b=kw["b"].half())
    filtered_lrelu.launches = filtered_lrelu.plain = 0
    with pytest.raises(ValueError, match="filtered_lrelu on CUDA"), torch.no_grad():
        filtered_lrelu(x, **kw)
    assert (filtered_lrelu.launches, filtered_lrelu.plain) == (0, 0)


@pytest.mark.cuda
def test_exported_program_launches_the_kernel():
    _card()
    x, kw = _call("layer1", 1, torch.bfloat16)

    class Layer(torch.nn.Module):
        def forward(self, x):
            return filtered_lrelu(x, **kw)

    program = torch.export.export(Layer(), (x,))
    filtered_lrelu.launches = filtered_lrelu.plain = 0
    with torch.no_grad():
        got = program.module()(x)
        want = filtered_lrelu(x, **kw)
    assert (filtered_lrelu.launches, filtered_lrelu.plain) == (2, 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sg3_frame_launches_nine_kernels():
    """A bf16 B=2 frame of the SG3 G at the flagship's widths: 9 launches, no plain call."""
    _card()
    G = Ide3dGenerator(GeneratorConfig(sr_arch="sg3")).init(0).to("cuda").eval().requires_grad_(False)
    ws = torch.randn(2, G.num_ws, G.w_dim, device="cuda")
    c = torch.tensor(np.tile(np.r_[np.eye(4).reshape(-1), [4.26, 0, 0.5, 0, 4.26, 0.5, 0, 0, 1]], (2, 1)),
                     dtype=torch.float32, device="cuda")
    c[:, 11] = 2.7
    filtered_lrelu.launches = filtered_lrelu.plain = 0
    with torch.no_grad():
        img = G.synthesis(ws, c)
    torch.cuda.synchronize()
    assert (filtered_lrelu.launches, filtered_lrelu.plain) == (9, 0)
    assert img.shape == (2, 512, 512, 3) and bool(torch.isfinite(img).all())


@pytest.mark.cuda
def test_sg3_frame_with_grad_launches_nine_kernels():
    """A fp32 B=1 frame of the SG3 G with the weights requiring gradients (a
    training step's G pass): 9 launches, no plain call, finite gradients."""
    _card()
    G = Ide3dGenerator(GeneratorConfig(sr_arch="sg3", dtype="float32")).init(0).to("cuda")
    ws = torch.randn(1, G.num_ws, G.w_dim, device="cuda")
    c = torch.tensor(np.r_[np.eye(4).reshape(-1), [4.26, 0, 0.5, 0, 4.26, 0.5, 0, 0, 1]][None],
                     dtype=torch.float32, device="cuda")
    c[:, 11] = 2.7
    filtered_lrelu.launches = filtered_lrelu.plain = 0
    img = G.synthesis(ws, c)
    assert (filtered_lrelu.launches, filtered_lrelu.plain) == (9, 0)
    img.float().square().mean().backward()
    grads = [p.grad for p in G.synthesis.sg3_sr.parameters() if p.grad is not None]
    assert grads and all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(G.synthesis.sg3_sr.layer0.weight.grad.abs().max()) > 0
