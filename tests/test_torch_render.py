"""The PyTorch port's camera, compositing, renderer and K1 plain version against
the JAX package, on the CPU, in fp32. Inputs are made with numpy from a seed.

K1 (ops/ray_march.py) on a CPU tensor runs its plain version; it is held to
`sort_integrate_pallas(..., interpret=True)` at tests/test_pallas.py's shapes
and tolerance (atol 3e-4), and to `integrate_rays_merged` on unsorted samples
for each option of the fine composite. The index arithmetic of the CUDA
kernel's ranking is replayed in numpy. The kernel itself, with each launch
plan it makes (staged or streamed, vector or scalar channel sums), is held to
the plain version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu.ops.pallas.ray_march import RAY_TILE, sort_integrate_pallas
from ide3d_tpu.render import camera as jcam
from ide3d_tpu.render import integration as jint
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.render.renderer import TriplaneRenderer as JRenderer
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.ops import ray_march
from ide3d_tpu_torch.render import camera as tcam
from ide3d_tpu_torch.render import integration as tint
from ide3d_tpu_torch.render.renderer import RenderParams, TriplaneRenderer
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, atol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=atol)


def _halves(z, vals):
    s = z.shape[2] // 2
    return t(z[:, :, :s]), t(vals[:, :, :s]), t(z[:, :, s:]), t(vals[:, :, s:])


# ----------------------------------------------------------------- camera

def test_initial_rays_and_world_transform():
    ref = jcam.get_initial_rays(2, 5, (6, 4), 18.0, 2.25, 3.3, offset=(0.1, -0.05))
    got = tcam.get_initial_rays(2, 5, (6, 4), 18.0, 2.25, 3.3, offset=(0.1, -0.05))
    for g, r in zip(got, ref):
        close(g.numpy(), r, atol=1e-6)

    c2w = np.stack([np.asarray(jcam.look_at_pose(y, 1.4, [0.0, 0.05, 0.0], radius=2.7))[0]
                    for y in (1.2, 1.9)])
    close(tcam.look_at_pose(1.2, 1.4, [0.0, 0.05, 0.0], radius=2.7).numpy()[0], c2w[0], atol=1e-6)
    close(tcam.make_label_25(t(c2w)).numpy(), jcam.make_label_25(jnp.asarray(c2w)), atol=0)
    ref_w = jcam.transform_rays_to_world(jnp.asarray(ref[0]), jnp.asarray(ref[2]), jnp.asarray(c2w))
    got_w = tcam.transform_rays_to_world(got[0], got[2], t(c2w))
    for g, r in zip(got_w, ref_w):
        close(g.numpy(), r, atol=1e-5)
    close(tcam.CANONICAL_POSE_25, jcam.CANONICAL_POSE_25, atol=0)


def test_perturb_z_vals_stays_within_a_bin():
    pts, z, d = tcam.get_initial_rays(1, 8, (4, 4), 18.0, 2.25, 3.3)
    pts2, z2 = tcam.perturb_z_vals(torch.Generator().manual_seed(0), pts, z, d)
    spacing = (3.3 - 2.25) / 7
    assert (z2 - z).abs().max() <= spacing / 2 + 1e-6
    close(pts2.numpy(), (pts + (z2 - z) * d[:, :, None, :]).numpy(), atol=1e-6)


# ------------------------------------------------------------- compositing

@pytest.mark.parametrize("opts", [
    dict(), dict(clamp_mode="relu"), dict(last_back=True), dict(white_back=True),
])
def test_integrate_rays(opts):
    rng = np.random.RandomState(0)
    B, R, S, C = 2, 16, 12, 5
    fs = rng.randn(B, R, S, C + 1).astype(np.float32) * 2
    z = np.sort(rng.rand(B, R, S, 1).astype(np.float32), axis=2) + 2.25
    d = rng.randn(B, R, 3).astype(np.float32)
    ref = jint.integrate_rays(jnp.asarray(fs), jnp.asarray(d), jnp.asarray(z), **opts)
    got = tint.integrate_rays(t(fs), t(d), t(z), **opts)
    for g, r in zip(got, ref):
        close(g.numpy(), r)
    _, _, w = tint.integrate_rays(t(fs), t(d), t(z), weights_only=True, **opts)
    if not opts.get("last_back"):
        close(w.numpy(), ref[2])


@pytest.mark.parametrize("opts", [
    dict(), dict(clamp_mode="relu"), dict(last_back=True), dict(white_back=True),
])
def test_integrate_rays_merged(opts):
    rng = np.random.RandomState(1)
    B, R, S, C = 2, 16, 20, 5
    fs = rng.randn(B, R, S, C + 1).astype(np.float32) * 3
    z = rng.rand(B, R, S, 1).astype(np.float32) + 2.25
    z[:, :, 3] = z[:, :, 7]  # a tie, broken by index
    d = rng.randn(B, R, 3).astype(np.float32)
    ref = jint.integrate_rays_merged(jnp.asarray(fs), jnp.asarray(d), jnp.asarray(z), **opts)
    got = tint.integrate_rays_merged(t(fs), t(d), t(z), **opts)
    for g, r in zip(got, ref):
        close(g.numpy(), r, atol=3e-5)


def test_sample_pdf_deterministic():
    rng = np.random.RandomState(2)
    R, S, N = 64, 10, 12
    w = rng.rand(R, S).astype(np.float32) ** 3
    bins = np.cumsum(rng.rand(R, S + 1).astype(np.float32), axis=1)
    ref = np.asarray(jint.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), N, det=True))
    got = tint.sample_pdf(t(bins), t(w), N, det=True).numpy()
    close(got[:, :-1], ref[:, :-1], atol=1e-5)
    # At u = 1 the bin hangs on the last ulp of the CDF sum (1 - 6e-8 or 1 + 1e-7,
    # from the summation order): either end of the last bin is right.
    assert ((got[:, -1] >= bins[:, -2] - 1e-5) & (got[:, -1] <= bins[:, -1] + 1e-5)).all()


def test_sample_pdf_random_is_in_range():
    bins = torch.linspace(2.25, 3.3, 11).expand(8, 11).contiguous()
    z = tint.sample_pdf(bins, torch.rand(8, 10), 32, generator=torch.Generator().manual_seed(0))
    assert z.shape == (8, 32) and (z >= 2.25).all() and (z <= 3.3).all()


# --------------------------------------------------------------------- K1

def test_k1_plain_matches_pallas_kernel(rng):
    B, R, S, C = 2, 2 * RAY_TILE, 24, 11
    z = rng.rand(B, R, S, 1).astype(np.float32) * 1.05 + 2.25
    vals = rng.randn(B, R, S, C + 1).astype(np.float32)
    norm = rng.rand(B, R, 1).astype(np.float32) + 0.5
    ref = sort_integrate_pallas(jnp.asarray(z), jnp.asarray(vals), jnp.asarray(norm), interpret=True)
    got = ray_march.sort_integrate(*_halves(z, vals), t(norm))
    for g, r in zip(got, ref):
        close(g.numpy(), r, atol=3e-4)
    assert ray_march.sort_integrate.launches == 0  # the CPU path never counts as a launch


def test_k1_plain_saturated_density(rng):
    B, R, S, C = 1, RAY_TILE, 8, 3
    z = np.sort(rng.rand(B, R, S, 1).astype(np.float32), axis=2)
    vals = rng.randn(B, R, S, C + 1).astype(np.float32)
    vals[..., -1] = 100.0
    norm = np.ones((B, R, 1), np.float32)
    ref = sort_integrate_pallas(jnp.asarray(z), jnp.asarray(vals), jnp.asarray(norm), interpret=True)
    feat, depth, wsum = ray_march.sort_integrate(*_halves(z, vals), t(norm))
    assert all(torch.isfinite(x).all() for x in (feat, depth, wsum))
    close(wsum.numpy(), np.ones_like(wsum.numpy()), atol=1e-4)
    for g, r in zip((feat, depth, wsum), ref):
        close(g.numpy(), r, atol=3e-4)


def test_k1_plain_matches_integrate_rays_merged():
    """Unsorted, overlapping coarse and fine halves, with ties across them."""
    rng = np.random.RandomState(4)
    B, R, S, C = 2, 32, 16, 7
    za = rng.rand(B, R, S, 1).astype(np.float32) + 2.25
    zb = rng.rand(B, R, S, 1).astype(np.float32) + 2.25
    zb[:, :, 2] = za[:, :, 5]
    va = rng.randn(B, R, S, C + 1).astype(np.float32) * 3
    vb = rng.randn(B, R, S, C + 1).astype(np.float32) * 3
    d = rng.randn(B, R, 3).astype(np.float32)
    comp, depth, w = jint.integrate_rays_merged(
        jnp.asarray(np.concatenate([va, vb], 2)), jnp.asarray(d),
        jnp.asarray(np.concatenate([za, zb], 2)))
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    got = ray_march.sort_integrate(t(za), t(va), t(zb), t(vb), t(norm))
    for g, r in zip(got, (comp, depth, np.asarray(w).sum(-2))):
        close(g.numpy(), r, atol=3e-5)


K1_OPTIONS = [
    dict(), dict(clamp_mode="relu"), dict(last_back=True), dict(white_back=True),
    dict(noise=True), dict(clamp_mode="relu", last_back=True, white_back=True, noise=True),
]


@pytest.mark.parametrize("halves", [(12, 12), (5, 19), (1, 1)])
@pytest.mark.parametrize("opts", K1_OPTIONS)
def test_k1_plain_options_match_integrate_rays_merged(opts, halves):
    """Each option of the fine composite, on unsorted halves with ties forced
    within and across them (depths on a 1/8 grid)."""
    opts = dict(opts)
    rng = np.random.RandomState(7)
    (sa, sb), B, R, C = halves, 2, 24, 6
    za, zb = (np.round((rng.rand(B, R, s, 1) * 1.05 + 2.25) * 8).astype(np.float32) / 8
              for s in halves)
    va = rng.randn(B, R, sa, C + 1).astype(np.float32) * 3
    vb = rng.randn(B, R, sb, C + 1).astype(np.float32) * 3
    d = rng.randn(B, R, 3).astype(np.float32)
    noise = rng.randn(B, R, sa + sb).astype(np.float32) * 0.5 if opts.pop("noise", False) else None
    fs = np.concatenate([va, vb], 2)
    if noise is not None:
        fs[..., -1] += noise
    comp, depth, w = jint.integrate_rays_merged(
        jnp.asarray(fs), jnp.asarray(d), jnp.asarray(np.concatenate([za, zb], 2)), **opts)
    norm = np.linalg.norm(d, axis=-1, keepdims=True)
    got = ray_march.sort_integrate(t(za), t(va), t(zb), t(vb), t(norm),
                                   noise=None if noise is None else t(noise), **opts)
    for g, r in zip(got, (comp, depth, np.asarray(w).sum(-2))):
        assert torch.isfinite(g).all()
        close(g.numpy(), r, atol=3e-5)


def _replay_rank(za, zb):
    """The kernel's rank_items: an unsorted half is counted by comparison; a
    sorted half ranks its own samples by index and is binary-searched, in
    bit_length(max(Sa, Sb)) steps, by the other half's samples."""
    sa, sb = len(za), len(zb)
    z, S, big = np.concatenate([za, zb]), sa + sb, np.iinfo(np.int32).max
    srt = [bool(np.all(h[:-1] <= h[1:])) for h in (za, zb)]

    def before(zh, j, x, thr):
        return zh[j] < x or (zh[j] == x and j < thr)

    rank = np.zeros(S, np.int64)
    for h, (zh, first) in enumerate(((za, 0), (zb, sa))):
        if not srt[h]:
            for i in range(S):
                own = first <= i < first + len(zh)
                thr = i - first if own else (big if h == 0 else 0)
                rank[i] += sum(before(zh, j, z[i], thr) for j in range(len(zh)))
    for i in range(S):
        in_a = i < sa
        if srt[0 if in_a else 1]:
            rank[i] += i if in_a else i - sa
        if srt[1 if in_a else 0]:
            arr, thr = (zb, 0) if in_a else (za, big)
            lo, ln = 0, len(arr)
            for _ in range(max(sa, sb).bit_length()):
                if ln > 0:
                    half = ln >> 1
                    if before(arr, lo + half, z[i], thr):
                        lo, ln = lo + half + 1, ln - half - 1
                    else:
                        ln = half
            assert ln == 0
            rank[i] += lo
    return rank


@pytest.mark.parametrize("sort_a,sort_b", [(True, True), (True, False), (False, True), (False, False)])
def test_k1_rank_replay_is_the_stable_order(sort_a, sort_b):
    rng = np.random.RandomState(8)
    for sa, sb in ((96, 96), (5, 130), (1, 1), (7, 3)):
        za = np.round(rng.rand(sa) * 8).astype(np.float32) / 8
        zb = np.round(rng.rand(sb) * 8).astype(np.float32) / 8
        za = np.sort(za) if sort_a else za
        zb = np.sort(zb) if sort_b else zb
        order = np.argsort(np.concatenate([za, zb]), kind="stable")
        expect = np.empty_like(order)
        expect[order] = np.arange(sa + sb)
        np.testing.assert_array_equal(_replay_rank(za, zb), expect)


def test_k1_wrapper_refuses_what_the_kernel_does_not_take():
    z, v = torch.zeros(1, 4, 3, 1), torch.zeros(1, 4, 3, 5)
    n = torch.ones(1, 4, 1)
    ray_march._check(z, v, z, v, n)
    with pytest.raises(TypeError):
        ray_march._check(z, v.half(), z, v.half(), n)
    with pytest.raises(ValueError):
        ray_march._check(z, v, z, v[:, :, :2], n)
    with pytest.raises(ValueError):
        ray_march._check(z, v.transpose(1, 2), z, v, n)
    with pytest.raises(ValueError):
        big = torch.zeros(1, 4, 200, 1)
        ray_march._check(big, torch.zeros(1, 4, 200, 5), big, torch.zeros(1, 4, 200, 5), n)
    ray_march._check(z, v, z, v, n, noise=torch.zeros(1, 4, 6))
    with pytest.raises(ValueError):
        ray_march._check(z, v, z, v, n, noise=torch.zeros(1, 4, 3))
    with pytest.raises(TypeError):
        ray_march._check(z, v, z, v, n, noise=torch.zeros(1, 4, 6, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ray_march._check(z, v, z, v, n, noise=torch.zeros(1, 6, 4).transpose(1, 2))
    with pytest.raises(ValueError):
        ray_march._check(z, v, z, v, n, clamp_mode="exp")
    with pytest.raises(NotImplementedError):
        ray_march.sort_integrate(*(x.to("meta") for x in (z, v, z, v, n)))


# ---------------------------------------------------------------- renderer

@pytest.fixture(scope="module")
def renderer_pair():
    jr = JRenderer(feature_channels=8, seg_channels=5)
    params = jr.init(jax.random.PRNGKey(1))
    tr = TriplaneRenderer(feature_channels=8, seg_channels=5)
    load_jax_params(tr, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.RandomState(5)
    planes = (rng.randn(2, 16, 16, 24).astype(np.float32), rng.randn(2, 16, 16, 15).astype(np.float32))
    return jr, params, tr, planes


def test_decode_and_sample_voxel(renderer_pair):
    jr, params, tr, (img_v, seg_v) = renderer_pair
    rng = np.random.RandomState(6)
    feat = rng.randn(3, 10, 8).astype(np.float32)
    close(tr.decode_features(t(feat)).detach().numpy(),
          jr.decode_features(params, jnp.asarray(feat)))
    coords = rng.rand(2, 64, 3).astype(np.float32) * 2.2 - 1.1
    ref = jr.sample_voxel(params, jnp.asarray(img_v), jnp.asarray(seg_v), jnp.asarray(coords))
    got = tr.sample_voxel(t(img_v), t(seg_v), t(coords))
    close(got.detach().numpy(), ref)


@pytest.mark.parametrize("opts", [
    dict(), dict(white_back=True), dict(hierarchical=False), dict(clamp_mode="relu"),
    dict(last_back=True), dict(clamp_mode="relu", last_back=True, white_back=True),
])
@torch.inference_mode()
def test_render_matches_jax(renderer_pair, opts):
    """The deterministic render (coarse pass, sample_pdf, fine pass, composite);
    the fine composite is the plain K1 for every option."""
    jr, params, tr, (img_v, seg_v) = renderer_pair
    c2w = np.array(jcam.look_at_pose(1.7, 1.5, [0.0, 0.0, 0.0], radius=2.7, batch_size=2))
    c2w[1] = np.asarray(jcam.look_at_pose(1.3, 1.6, [0.0, 0.0, 0.0], radius=2.7))[0]
    jrp = JRenderParams(img_size=8, num_steps=10, **opts)
    ref = jax.jit(lambda *a: jr.render(*a, jrp))(
        params, jnp.asarray(img_v), jnp.asarray(seg_v), jnp.asarray(c2w))
    got = tr.render(t(img_v), t(seg_v), t(c2w), RenderParams(img_size=8, num_steps=10, **opts))
    for key in ("feature", "seg", "depth", "weights_sum"):
        close(got[key].numpy(), ref[key], atol=1e-4)


@torch.inference_mode()
def test_render_fine_noise_is_the_draw_of_integrate_rays_merged(renderer_pair):
    """With a generator and density noise, render_fine (K1) gives what
    integrate_rays_merged gives from the same generator state."""
    _, _, tr, (img_v, seg_v) = renderer_pair
    c2w = np.array(jcam.look_at_pose(1.7, 1.5, [0.0, 0.0, 0.0], radius=2.7, batch_size=2))
    rp = RenderParams(img_size=8, num_steps=10, nerf_noise=0.7, last_back=True)
    gen = torch.Generator().manual_seed(3)
    st = tr.render_coarse(t(img_v), t(seg_v), t(c2w), rp, generator=gen)
    state = gen.get_state()
    got = tr.render_fine(st, rp)
    gen.set_state(state)
    comp, depth, w = tint.integrate_rays_merged(
        torch.cat([st["coarse"], tr.sample_table(st["table"], (
            st["origins"][:, :, None, :] + st["dirs"][:, :, None, :] * st["fine_z"]
        ).reshape(2, -1, 3)).reshape(2, 64, 10, -1)], dim=-2),
        st["rays_d_cam"], torch.cat([st["z_vals"], st["fine_z"]], dim=-2), generator=gen,
        noise_std=rp.nerf_noise, last_back=True)
    close(got["feature"].reshape(2, 64, -1).numpy(), comp[..., :8].numpy(), atol=1e-5)
    close(got["seg"].reshape(2, 64, -1).numpy(), comp[..., 8:].numpy(), atol=1e-5)
    close(got["depth"].reshape(2, 64, 1).numpy(), depth.numpy(), atol=1e-5)
    close(got["weights_sum"].reshape(2, 64, 1).numpy(), w.sum(-2).numpy(), atol=1e-5)
    gen.set_state(state)
    other = tr.render_fine(st, dataclasses.replace(rp, nerf_noise=0.0))
    assert not torch.allclose(other["feature"], got["feature"])
