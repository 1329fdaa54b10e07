"""The CUDA kernels of the port against their plain versions, on a CUDA card.

Marked `cuda`; each test skips without a card. The file imports no JAX, so it
runs on a machine with PyTorch alone (tests/conftest.py imports JAX, hence
`--noconftest`):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from ide3d_tpu_torch.ops import ray_march
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() * x.element_size() + 64, dtype=torch.uint8, device=x.device)
    off = (4 - buf.data_ptr()) % 16
    out = buf[off:off + x.numel() * x.element_size()].view(x.dtype).view(x.shape)
    return out.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,opts", [
    # (Sa, Sb, C+1, vals dtype, misaligned vals_a): each launch plan of the kernel
    ((96, 96, 52, "bfloat16", False), dict()),  # the frame's: staged, 2 rows = 13 vectors
    ((96, 96, 52, "float32", False), dict(noise=True)),  # staged, 1 row = 13 vectors
    ((8, 8, 9, "bfloat16", False), dict(clamp_mode="relu")),  # staged, 8 rows = 9 vectors
    ((8, 12, 4, "float32", False), dict(last_back=True)),  # staged, 1 row = 1 vector
    ((16, 16, 256, "bfloat16", False), dict(white_back=True)),  # staged, 1 row = 32 vectors
    ((8, 8, 2, "float32", False), dict(noise=True)),  # staged, scalar sums (8-byte rows)
    ((5, 130, 4, "float32", False), dict(last_back=True)),  # streamed: a 20-byte half
    ((1, 1, 2, "float32", False), dict(white_back=True)),  # streamed: 1-sample halves
    ((200, 56, 256, "float32", False), dict(clamp_mode="relu")),  # streamed: above 64 KB
    ((96, 96, 52, "bfloat16", True), dict(noise=True)),  # streamed: a misaligned pointer
])
def test_k1_kernel_matches_plain_on_card(shape, opts):
    """The CUDA kernel against its plain version, depths on a 1/8 grid (ties
    within and across the halves), max abs err <= 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (sa, sb, c1, dtype, misaligned), opts = shape, dict(opts)
    rng = np.random.RandomState(sa + sb + c1)
    B, R = 2, 40
    args = []
    for s in (sa, sb):
        z = np.round((rng.rand(B, R, s, 1) * 1.05 + 2.25) * 8).astype(np.float32) / 8
        v = rng.randn(B, R, s, c1).astype(np.float32) * 3
        args += [t(z).cuda(), t(v).to("cuda", getattr(torch, dtype))]
    args.append(t(rng.rand(B, R, 1).astype(np.float32) + 0.5).cuda())
    if misaligned:
        args[1] = _misaligned(args[1])
        assert args[1].data_ptr() % 16 == 4 and args[1].is_contiguous()
    if opts.pop("noise", False):
        opts["noise"] = t(rng.randn(B, R, sa + sb).astype(np.float32)).cuda()
    before = ray_march.sort_integrate.launches
    got = ray_march.sort_integrate(*args, **opts)
    assert ray_march.sort_integrate.launches == before + 1
    ref = ray_march.sort_integrate_plain(*args, **opts)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-4, rtol=1e-4)


def _k1_backward_case(shape, opts, sorted_halves, R=2048, ties=True):
    """Inputs of one backward case: depths on a 1/8 grid (ties within and
    across the halves; continuous with ties=False), densities that keep every
    alpha below 1 - 1e-6, B=2 and R rays per image, so that the persistent
    blocks walk over several rays each; returns (args, cotangents, options)."""
    (sa, sb, c1, dtype, misaligned), opts = shape, dict(opts)
    rng = np.random.RandomState(sa + 3 * sb + c1 + R)
    B = 2
    args = []
    for s in (sa, sb):
        z = (rng.rand(B, R, s, 1) * 1.05 + 2.25).astype(np.float32)
        if ties:
            z = np.round(z * 8) / 8
        if sorted_halves:
            z = np.sort(z, axis=2)
        v = rng.randn(B, R, s, c1).astype(np.float32)
        args += [t(z).cuda(), t(v).to("cuda", getattr(torch, dtype))]
    args.append(t(rng.rand(B, R, 1).astype(np.float32) + 0.5).cuda())
    if misaligned:
        args[1] = _misaligned(args[1])
        assert args[1].data_ptr() % 16 == 4 and args[1].is_contiguous()
    if opts.pop("noise", False):
        opts["noise"] = t(rng.randn(B, R, sa + sb).astype(np.float32) * 0.5).cuda()
    cot = [t(rng.randn(B, R, n).astype(np.float32)).cuda() for n in (c1 - 1, 1, 1)]
    return args, cot, opts


def _check_backward(got, args, cot, opts):
    """max abs err <= 1e-4 x max|grad| in fp32, 1e-2 x in bf16 (the gradient is
    rounded to bf16 once; the plain version rounds the same sums in another
    order), against autograd through the plain version."""
    ref = ray_march.sort_integrate_backward_plain(*args, *cot, **opts)
    scale = max(float(r.float().abs().max()) for r in ref)
    tol = 1e-4 if args[1].dtype == torch.float32 else 1e-2
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert torch.isfinite(g.float()).all()
        assert float((g.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape,opts", [
    # (Sa, Sb, C+1, vals dtype, misaligned vals_a): each launch plan of the backward
    ((96, 96, 52, "bfloat16", False), dict()),  # the training render's: staged, 2 rows = 13 vectors
    ((96, 96, 52, "float32", False), dict(noise=True)),  # staged, 1 row = 13 vectors
    ((8, 8, 9, "bfloat16", False), dict(clamp_mode="relu")),  # staged, 8 rows = 9 vectors
    ((8, 12, 4, "float32", False), dict(last_back=True)),  # staged, 1 row = 1 vector
    ((16, 16, 256, "bfloat16", False), dict(white_back=True)),  # staged, 1 row = 32 vectors
    ((8, 8, 2, "float32", False), dict(noise=True)),  # staged, scalar (8-byte rows)
    ((5, 130, 4, "float32", False), dict(last_back=True)),  # streamed: a 20-byte half
    ((1, 1, 2, "float32", False), dict(white_back=True)),  # streamed: 1-sample halves
    ((200, 56, 256, "float32", False),  # streamed: above 64 KB, in row chunks
     dict(clamp_mode="relu", last_back=True, white_back=True, noise=True)),
    ((96, 96, 52, "bfloat16", True), dict(noise=True)),  # streamed: a misaligned pointer
])
@pytest.mark.parametrize("sorted_halves", [False, True])
def test_k1_backward_matches_plain_on_card(shape, opts, sorted_halves):
    """The CUDA backward against autograd through the plain version, for each
    launch plan the kernel makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, cot, opts = _k1_backward_case(shape, opts, sorted_halves,
                                        R=1024 if shape[2] == 256 else 2048)
    before = ray_march.sort_integrate_backward.launches
    got = ray_march.sort_integrate_backward(*args, *cot, **opts)
    assert ray_march.sort_integrate_backward.launches == before + 1
    _check_backward(got, args, cot, opts)


@pytest.mark.cuda
def test_k1_backward_back_to_back_on_card():
    """Backward calls queued on one stream with no synchronisation between
    them, on different inputs and plans (so different shared-memory sizes),
    each right: no stage, barrier or launch attribute is reused stale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [_k1_backward_case(shape, opts, sorted_halves, R=R) for shape, opts, sorted_halves, R in (
        ((96, 96, 52, "bfloat16", False), dict(), True, 4096),
        ((96, 96, 52, "bfloat16", False), dict(noise=True), False, 4095),
        ((8, 8, 9, "bfloat16", False), dict(), False, 2048),
        ((96, 96, 52, "float32", False), dict(last_back=True), False, 2048),
        ((96, 96, 52, "bfloat16", True), dict(), False, 2048),
    )]
    torch.cuda.synchronize()
    outs = [ray_march.sort_integrate_backward(*args, *cot, **opts) for args, cot, opts in cases]
    torch.cuda.synchronize()
    for got, (args, cot, opts) in zip(outs, cases):
        _check_backward(got, args, cot, opts)


def _k1_double_backward_case(shape, opts, sorted_halves, R):
    """A backward case (continuous depths with opts["ties"] False), and the
    cotangents gg of the backward's two gradients (gg_a misaligned with
    opts["misaligned_gg"]); returns (args, cotangents, gg, options)."""
    opts = dict(opts)
    misaligned_gg, ties = opts.pop("misaligned_gg", False), opts.pop("ties", True)
    args, cot, opts = _k1_backward_case(shape, opts, sorted_halves, R=R, ties=ties)
    rng = np.random.RandomState(7)
    gg = [t(rng.randn(*v.shape).astype(np.float32)).to("cuda", v.dtype) for v in (args[1], args[3])]
    if misaligned_gg:
        gg[0] = _misaligned(gg[0])
        assert gg[0].data_ptr() % 16 == 4 and gg[0].is_contiguous()
    return args, cot, gg, opts


def _check_double_backward(got, args, cot, gg, opts):
    """max abs err <= 1e-4 x max|grad| in fp32, 1e-2 x in bf16, of the value
    gradients and of the cotangent gradients, each group against its own
    max, against autograd (create_graph) through the plain version."""
    ref = ray_march.sort_integrate_double_backward_plain(*args, *cot, *gg, **opts)
    tol = 1e-4 if args[1].dtype == torch.float32 else 1e-2
    for group in ((got[:2], ref[:2]), (got[2:], ref[2:])):
        scale = max(float(r.float().abs().max()) for r in group[1])
        for g, r in zip(*group):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert torch.isfinite(g.float()).all()
            assert float((g.float() - r.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape,opts,plan", [
    # (Sa, Sb, C+1, vals dtype, misaligned vals_a): each launch plan of the double backward
    ((96, 96, 52, "bfloat16", False), dict(), "staged"),  # the training render's, 13-vector units
    ((96, 96, 52, "float32", False), dict(noise=True), "staged"),  # 80 KB of slabs, 2 blocks a SM
    ((96, 96, 52, "float32", False),  # continuous depths: every delta > 0
     dict(last_back=True, white_back=True, ties=False), "staged"),
    ((8, 8, 9, "bfloat16", False), dict(clamp_mode="relu"), "staged"),  # 8 rows = 9 vectors
    ((8, 12, 4, "float32", False), dict(last_back=True, clamp_mode="relu"), "staged"),  # 1 vector
    ((16, 16, 256, "bfloat16", False), dict(white_back=True), "staged"),  # 1 row = 32 vectors
    ((8, 8, 2, "float32", False), dict(noise=True), "streamed"),  # rows below 16 bytes
    ((8, 8, 255, "bfloat16", False), dict(last_back=True), "streamed"),  # 255-vector units
    ((5, 130, 4, "float32", False), dict(white_back=True), "streamed"),  # a 20-byte half
    ((1, 1, 2, "float32", False), dict(last_back=True), "streamed"),  # 1-sample halves, one channel
    ((200, 56, 256, "float32", False),  # S = 256, C + 1 = 256: 512 KB of slabs a ray
     dict(clamp_mode="relu", last_back=True, white_back=True, noise=True), "streamed"),
    ((96, 96, 52, "bfloat16", True), dict(noise=True), "streamed"),  # a misaligned vals_a
    ((96, 96, 52, "bfloat16", False), dict(misaligned_gg=True), "streamed"),  # a misaligned gg_a
])
@pytest.mark.parametrize("sorted_halves", [False, True])
def test_k1_double_backward_matches_plain_on_card(shape, opts, plan, sorted_halves):
    """The CUDA double backward against autograd (create_graph) through the
    plain version, for each launch plan the kernel makes (read back from the
    C++): max abs err <= 1e-4 x max|grad| in fp32, 1e-2 x in bf16, of the
    value gradients and of the cotangent gradients, each group against its
    own max."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, cot, gg, opts = _k1_double_backward_case(shape, opts, sorted_halves,
                                                   R=512 if shape[2] >= 255 else 1024)
    assert ray_march.double_backward_plan(*args, *cot, *gg, **opts) == plan
    before = ray_march.sort_integrate_double_backward.launches
    got = ray_march.sort_integrate_double_backward(*args, *cot, *gg, **opts)
    assert ray_march.sort_integrate_double_backward.launches == before + 1
    _check_double_backward(got, args, cot, gg, opts)


@pytest.mark.cuda
def test_k1_double_backward_back_to_back_on_card():
    """Double backward calls queued on one stream with no synchronisation
    between them, on different inputs, options and plans (so different
    kernels and shared-memory sizes), each right: no stage is refilled before
    its bulk store has read it, and no barrier or launch attribute is reused
    stale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [_k1_double_backward_case(shape, opts, sorted_halves, R)
             for shape, opts, sorted_halves, R in (
        ((96, 96, 52, "bfloat16", False), dict(), True, 4096),
        ((96, 96, 52, "bfloat16", False), dict(noise=True, last_back=True), False, 4095),
        ((8, 8, 9, "bfloat16", False), dict(clamp_mode="relu"), False, 2048),
        ((96, 96, 52, "float32", False), dict(white_back=True, ties=False), False, 2048),
        ((96, 96, 52, "bfloat16", False), dict(misaligned_gg=True), False, 1024),
        ((8, 8, 2, "float32", False), dict(noise=True), True, 2048),
        ((96, 96, 52, "bfloat16", False), dict(ties=False), False, 77),
    )]
    plans = {ray_march.double_backward_plan(*args, *cot, *gg, **opts)
             for args, cot, gg, opts in cases}
    assert plans == {"staged", "streamed"}
    torch.cuda.synchronize()
    outs = [ray_march.sort_integrate_double_backward(*args, *cot, *gg, **opts)
            for args, cot, gg, opts in cases]
    torch.cuda.synchronize()
    for got, (args, cot, gg, opts) in zip(outs, cases):
        _check_double_backward(got, args, cot, gg, opts)


@pytest.mark.cuda
def test_k1_differentiates_twice_on_card():
    """A create_graph gradient of K1 on the card, differentiated again, equals
    the CPU's (plain K1) within 1e-4 of its max; one backward and one double
    backward launch; a third derivative raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args, cot, opts = _k1_backward_case((16, 24, 9, "float32", False), dict(last_back=True), False,
                                        R=256)
    res = {}
    for dev in ("cpu", "cuda"):
        a = [x.to(dev) for x in args]
        va, vb = a[1].clone().requires_grad_(), a[3].clone().requires_grad_()
        outs = ray_march.sort_integrate(a[0], va, a[2], vb, a[4], **opts)
        before = (ray_march.sort_integrate_backward.launches,
                  ray_march.sort_integrate_double_backward.launches)
        g = torch.autograd.grad(sum((o * c.to(dev)).sum() for o, c in zip(outs, cot)), (va, vb),
                                create_graph=True)
        second = torch.autograd.grad(sum(x.square().sum() for x in g), (va, vb), create_graph=True)
        if dev == "cuda":
            assert (ray_march.sort_integrate_backward.launches,
                    ray_march.sort_integrate_double_backward.launches) == (before[0] + 1, before[1] + 1)
            with pytest.raises(RuntimeError, match="twice"):
                sum(x.sum() for x in second).backward()
        res[dev] = [x.detach().cpu() for x in second]
    scale = max(float(x.abs().max()) for x in res["cpu"])
    for got, ref in zip(res["cuda"], res["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_render_fine_carries_the_gradient_on_card():
    """The fine composite on the card is differentiable: a loss on render_fine's
    outputs reaches the planes and the decoder through K1's backward, with the
    gradients of the CPU (plain K1) render on the same weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ide3d_tpu_torch.render.camera import look_at_pose
    from ide3d_tpu_torch.render.renderer import RenderParams, TriplaneRenderer

    rng = np.random.RandomState(11)
    planes = [t(rng.randn(2, 16, 16, n).astype(np.float32)) for n in (24, 15)]
    c2w = look_at_pose(1.7, 1.5, [0.0, 0.0, 0.0], radius=2.7, batch_size=2)
    rp = RenderParams(img_size=8, num_steps=10)
    grads = {}
    for dev in ("cpu", "cuda"):
        r = TriplaneRenderer(feature_channels=8, seg_channels=5)
        r.init_parameters(torch.Generator().manual_seed(0))
        r = r.to(dev)
        img_v, seg_v = (p.clone().to(dev).requires_grad_() for p in planes)
        before = ray_march.sort_integrate_backward.launches
        out = r.render(img_v, seg_v, c2w.to(dev), rp)
        loss = sum((out[k] * (i + 1)).square().mean() for i, k in enumerate(
            ("feature", "seg", "depth", "weights_sum")))
        loss.backward()
        if dev == "cuda":
            assert ray_march.sort_integrate_backward.launches == before + 1
        grads[dev] = [img_v.grad, seg_v.grad, r.dec_w1.grad, r.dec_w2.grad]
    for g_cpu, g_cuda in zip(grads["cpu"], grads["cuda"]):
        assert g_cuda is not None and float(g_cuda.abs().max()) > 0
        scale = float(g_cpu.abs().max())
        assert float((g_cuda.cpu() - g_cpu).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_k1_autograd_refuses_depth_gradients_on_card():
    """The CUDA composite differentiates in the values only: a depth, |ray_d|
    or noise tensor that requires a gradient is refused, not silently dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(1)
    z = t(np.sort(rng.rand(1, 8, 4, 1).astype(np.float32), axis=2)).cuda()
    v = t(rng.randn(1, 8, 4, 5).astype(np.float32)).cuda()
    n = t(rng.rand(1, 8, 1).astype(np.float32) + 0.5).cuda()
    feat, _, _ = ray_march.sort_integrate(z, v.requires_grad_(), z, v, n)
    assert feat.grad_fn is not None
    with pytest.raises(ValueError):
        ray_march.sort_integrate(z.requires_grad_(), v, z.detach(), v, n)


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [False, True])
def test_k1_operator_launches_the_kernel_on_card(noise):
    """K1's operator (what a torch.export program calls) on CUDA tensors
    launches the kernel once a call and equals sort_integrate; opcheck holds
    its schema and fake shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(5)
    B, R, sa, sb, c1 = 2, 40, 12, 20, 9
    args = []
    for s in (sa, sb):
        args += [t(rng.rand(B, R, s, 1).astype(np.float32) * 1.05 + 2.25).cuda(),
                 t(rng.randn(B, R, s, c1).astype(np.float32)).to("cuda", torch.bfloat16)]
    args.append(t(rng.rand(B, R, 1).astype(np.float32) + 0.5).cuda())
    nz = t(rng.randn(B, R, sa + sb).astype(np.float32)).cuda() if noise else None
    before = ray_march.sort_integrate.launches
    got = ray_march.OP(*args, nz, "softplus", True, False)
    assert ray_march.sort_integrate.launches == before + 1
    want = ray_march.sort_integrate(*args, noise=nz, last_back=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert torch.equal(g, w)
    torch.library.opcheck(ray_march.OP, (*args, nz, "relu", False, True))
