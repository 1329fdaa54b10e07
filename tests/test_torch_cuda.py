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
