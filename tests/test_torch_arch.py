"""The port's optional generator architectures against the JAX package, on the CPU.

The hybrid tri-plane/voxel G (use_feature_volume), the SG3 superres G
(sr_arch="sg3") and the built-in encoder G (use_encoder) at the tiny width of
tests/test_models.py, initialised by JAX and bridged into the port through
io/from_jax.py, and their pieces: grid_sample_3d, filtered_lrelu, the filter
design and layer schedule, SynthesisLayer3, FeatureVolume, and a fine_steps
render. Inputs come from numpy seeds. fp32 outputs within 2e-4 (the golden
test's tolerance) times max(1, max|ref|); the ops alone within 1e-5 of their
scale. bf16 volume samples: the port lerps in fp32 and rounds once (within
2^-8 of the scale of the exact lerp), the JAX package lerps in bf16 with bf16
weights (three weight roundings, three products and seven sums), so the two
are held within 4 x 2^-8 of the scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ide3d_tpu import render as jrender
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models import feature_volume as jfv
from ide3d_tpu.models import layers_sg3 as jsg3
from ide3d_tpu.ops.filtered_lrelu import filtered_lrelu as jfiltered_lrelu
from ide3d_tpu.ops.grid_sample import grid_sample_3d as jgrid_sample_3d
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models import feature_volume, layers_sg3
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.ops import ray_march
from ide3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from ide3d_tpu_torch.ops.grid_sample import grid_sample_3d
from ide3d_tpu_torch.render import renderer as trenderer
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
ARCHS = {
    "hybrid": dict(use_feature_volume=True, fv_resolution=8, fv_base_channels=16),
    "sg3": dict(sr_arch="sg3"),
    "encoder": dict(use_encoder=True),
}
ATOL = 2e-4
OP_TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(name, got, ref, tol=ATOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}"
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


def _front(n=1):
    return np.stack([np.asarray(jrender.CANONICAL_POSE_25, np.float32)] * n)


@pytest.fixture(scope="module")
def bridged():
    """bridged(arch) -> (JAX G, its params from PRNGKey(0), the port's G with
    the same weights), each built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            rp = dict(img_size=8, num_steps=4)
            jG = JGenerator(JGeneratorConfig(**TINY, **ARCHS[arch], render=JRenderParams(**rp)))
            params = jax.jit(jG.init)(jax.random.PRNGKey(0))
            G = Ide3dGenerator(GeneratorConfig(**TINY, **ARCHS[arch], render=RenderParams(**rp)))
            load_jax_params(G, _np(params))
            built[arch] = (jG, params, G.eval())
        return built[arch]

    return get


# ----------------------------------------------------------------- the configs


def test_configs_have_every_jax_field():
    """GeneratorConfig and RenderParams carry every field of the JAX
    dataclasses with the JAX default."""
    for port_cls, jax_cls in ((GeneratorConfig, JGeneratorConfig), (RenderParams, JRenderParams)):
        own = {f.name: f for f in dataclasses.fields(port_cls)}
        for f in dataclasses.fields(jax_cls):
            assert f.name in own, f"{port_cls.__name__} lacks {f.name}"
            if f.name != "render":
                assert getattr(port_cls(), f.name) == getattr(jax_cls(), f.name), f.name


# -------------------------------------------------------------------- the ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_3d_matches_jax(dtype):
    """Points inside, on each face and outside the volume (zeros padding)."""
    rng = np.random.RandomState(0)
    vol = rng.randn(2, 5, 6, 7, 3).astype(np.float32)  # JAX layout [B, D, H, W, C]
    pts = rng.uniform(-1.3, 1.3, (2, 60, 3)).astype(np.float32)
    for axis in range(3):
        pts[:, axis * 8:(axis + 1) * 8, axis] = np.repeat([[-1.0], [1.0]], 4)
    pts[:, -4:] = [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.5, 0.0, 0.0], [0.0, -2.0, 0.0]]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jgrid_sample_3d(jnp.asarray(vol, jdt), jnp.asarray(pts)).astype(jnp.float32))
    tvol = torch.from_numpy(vol.transpose(0, 4, 1, 2, 3).copy()).to(getattr(torch, dtype))
    got = grid_sample_3d(tvol, torch.from_numpy(pts))
    assert got.dtype == tvol.dtype and got.shape == (2, 60, 3)
    assert float(got[:, -2:].abs().max()) == 0.0  # outside the volume: zeros
    if dtype == "bfloat16":
        exact = grid_sample_3d(tvol.float(), torch.from_numpy(pts)).numpy()
        _close("grid_sample_3d bf16 vs its fp32 lerp", got.float().numpy(), exact, 2.0**-8)
    tol = 4 * 2.0**-8 if dtype == "bfloat16" else OP_TOL
    _close(f"grid_sample_3d {dtype}", got.float().numpy(), want, tol)


FLRELU_CASES = [
    # (up, down, clamp, flip_filter, radial down filter)
    (1, 1, None, False, False),
    (2, 1, 0.5, False, False),
    (1, 2, None, True, False),
    (2, 2, 0.5, True, False),
    (2, 2, None, False, True),
]


@pytest.mark.parametrize("up,down,clamp,flip,radial", FLRELU_CASES)
def test_filtered_lrelu_matches_jax(up, down, clamp, flip, radial):
    """Kaiser filters designed as SynthesisLayer3 does, a bias, padding 3."""
    rng = np.random.RandomState(up + 2 * down)
    x = rng.randn(2, 11, 11, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    fu = jsg3.design_lowpass_filter(6 * up if up > 1 else 1, 3.0, 2.0, 16.0)
    fd = jsg3.design_lowpass_filter(6 * down if down > 1 else 1, 3.0, 2.0, 16.0, radial=radial)
    kw = dict(up=up, down=down, padding=(3, 2, 3, 2), clamp=clamp, flip_filter=flip)
    want = np.asarray(jfiltered_lrelu(jnp.asarray(x), fu, fd, jnp.asarray(b), **kw))
    got = filtered_lrelu(torch.from_numpy(x).permute(0, 3, 1, 2), fu, fd, torch.from_numpy(b), **kw)
    _close("filtered_lrelu", got.permute(0, 2, 3, 1).numpy(), want, OP_TOL)


def test_filter_design_and_schedule_match_jax():
    for args, kw in (((12, 8.0, 4.0, 64.0), {}), ((12, 8.0, 4.0, 64.0), {"radial": True}),
                     ((1, 8.0, 4.0, 64.0), {})):
        want = jsg3.design_lowpass_filter(*args, **kw)
        got = layers_sg3.design_lowpass_filter(*args, **kw)
        if want is None:
            assert got is None
        else:
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    for n, res in ((14, 128), (8, 64)):
        want = jsg3.sg3_layer_schedule(num_layers=n, img_resolution=res)
        got = layers_sg3.sg3_layer_schedule(num_layers=n, img_resolution=res)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


LAYER_CASES = {
    "refine": dict(is_torgb=False, in_channels=8, out_channels=6, in_size=16, out_size=16,
                   in_sampling_rate=16, out_sampling_rate=16, in_cutoff=6, out_cutoff=6,
                   in_half_width=2, out_half_width=2),
    "upsample": dict(is_torgb=False, in_channels=8, out_channels=6, in_size=8, out_size=16,
                     in_sampling_rate=8, out_sampling_rate=16, in_cutoff=3.2, out_cutoff=6.4,
                     in_half_width=0.8, out_half_width=1.6),
    "torgb": dict(is_torgb=True, in_channels=8, out_channels=3, in_size=16, out_size=16,
                  in_sampling_rate=16, out_sampling_rate=16, in_cutoff=8, out_cutoff=8,
                  in_half_width=2, out_half_width=2),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_synthesis_layer3_matches_jax(case):
    """The layer on bridged parameters, its bias and magnitude_ema moved off
    their init so that both show; and update_magnitude_ema."""
    spec = LAYER_CASES[case]
    jl = jsg3.SynthesisLayer3(w_dim=16, **spec)
    rng = np.random.RandomState(1)
    p = _np(jl.init(jax.random.PRNGKey(0)))
    p["bias"] = rng.randn(*p["bias"].shape).astype(np.float32)
    p["magnitude_ema"] = np.float32(2.3)
    x = rng.randn(2, spec["in_size"], spec["in_size"], spec["in_channels"]).astype(np.float32)
    w = rng.randn(2, 16).astype(np.float32)
    want = np.asarray(jl(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(w)))
    layer = load_jax_params(layers_sg3.SynthesisLayer3(w_dim=16, **spec), p)
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w))
        ema = layer.update_magnitude_ema(torch.from_numpy(x))
    _close(f"SynthesisLayer3 {case}", got.permute(0, 2, 3, 1).numpy(), want, OP_TOL)
    _close("update_magnitude_ema", ema.numpy(), np.asarray(jl.update_magnitude_ema(p, jnp.asarray(x))),
           OP_TOL)


@pytest.mark.parametrize("use_mapping", [True, False])
def test_feature_volume_matches_jax(use_mapping):
    """fv_resolution 8, base 16: stages at 4^3 and 8^3, the const and biases
    moved off their init; and the x2 trilinear growth against
    jax.image.resize on its own, edge voxels included."""
    kw = dict(feat_res=8, base_channels=16, output_channels=8, z_dim=12, use_mapping=use_mapping)
    jv = jfv.FeatureVolume(init_res=4, **kw)
    rng = np.random.RandomState(2)
    p = _np(jv.init(jax.random.PRNGKey(0)))
    p = jax.tree_util.tree_map(lambda a: a + 0.3 * rng.randn(*a.shape).astype(np.float32), p)
    z = rng.randn(2, 12).astype(np.float32)
    want = np.asarray(jv(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(z)))
    fv = load_jax_params(feature_volume.FeatureVolume(**kw), p)
    assert fv.stage_channels() == jv.stage_channels() == [16, 8]
    with torch.no_grad():
        got = fv(torch.from_numpy(z))
    assert got.shape == (2, 8, 8, 8, 8)
    _close("FeatureVolume", got.permute(0, 2, 3, 4, 1).numpy(), want, OP_TOL)

    x = rng.randn(1, 4, 4, 4, 3).astype(np.float32)
    want_up = np.asarray(jax.image.resize(jnp.asarray(x), (1, 8, 8, 8, 3), "trilinear"))
    got_up = F.interpolate(torch.from_numpy(x).permute(0, 4, 1, 2, 3), scale_factor=2,
                           mode="trilinear", align_corners=False).permute(0, 2, 3, 4, 1).numpy()
    _close("trilinear x2", got_up, want_up, OP_TOL)
    _close("trilinear x2 edges", got_up[:, [0, -1]][:, :, [0, -1]][:, :, :, [0, -1]],
           want_up[:, [0, -1]][:, :, [0, -1]][:, :, :, [0, -1]], OP_TOL)


def test_full_width_volume_shapes():
    """At the published width (fv_resolution 32, base 128, 32 out): stages of
    [128, 64, 32, 32] channels at 4^3..32^3."""
    S = Ide3dGenerator(GeneratorConfig(use_feature_volume=True)).synthesis
    assert S.feature_volume.stage_channels() == [128, 64, 32, 32]
    assert tuple(S.feature_volume.const.shape) == (1, 128, 4, 4, 4)
    assert S.feature_volume.mapping.out_features == 2 * (128 + 64 + 32 + 32)


# --------------------------------------------------------------- the generators


@pytest.mark.parametrize("arch", sorted(ARCHS))
@torch.inference_mode()
def test_bridged_generator_matches_jax(arch, bridged):
    """Every output of return_all at two latents, against the JAX G; the
    encoder G from cond_img with the camera from its yaw/pitch head, and
    encode()."""
    jG, params, G = bridged(arch)
    assert G.num_ws == jG.num_ws
    rng = np.random.RandomState(3)
    if arch == "encoder":
        img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        ref = jax.jit(lambda p, i: jG(p, cond_img=i, return_all=True))(params, jnp.asarray(img))
        got = G(cond_img=torch.from_numpy(img), return_all=True)
        jws, jcam = jG.encode(params, jnp.asarray(img))
        ws, cam = G.encode(torch.from_numpy(img))
        _close("encode ws", ws.numpy(), np.asarray(jws))
        _close("encode camera", cam.numpy(), np.asarray(jcam))
    else:
        z = rng.randn(2, 512).astype(np.float32)
        ref = jax.jit(lambda p, z, c: jG(p, z, c, return_all=True, truncation_psi=0.7))(
            params, jnp.asarray(z), jnp.asarray(_front(2)))
        got = G(torch.from_numpy(z), torch.from_numpy(_front(2)), return_all=True,
                truncation_psi=0.7)
    for key in ("img", "img_raw", "seg", "seg_raw", "depth", "weights_sum"):
        _close(f"{arch} {key}", got[key].numpy(), np.asarray(ref[key]))


@torch.inference_mode()
def test_generator_structure(bridged):
    """The state trees hold the new modules under the JAX names; sg3 keeps
    num_ws and builds no SG2 block; init covers the new modules, seeded."""
    jG, params, G = bridged("sg3")
    assert G.num_ws == Ide3dGenerator(GeneratorConfig(**TINY)).num_ws
    assert not any(k.startswith("synthesis.b") for k in G.state_dict())
    assert "synthesis.sg3_sr.torgb.magnitude_ema" in G.state_dict()
    full = Ide3dGenerator(GeneratorConfig(sr_arch="sg3")).synthesis.sg3_sr
    assert full.num_layers == 8 and full.layer7.weight.shape[0] == 32
    for arch in ARCHS:
        cfg = GeneratorConfig(**TINY, **ARCHS[arch])
        a = Ide3dGenerator(cfg).init(5).state_dict()
        b = Ide3dGenerator(cfg).init(5).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), arch
    a = Ide3dGenerator(GeneratorConfig(**TINY, **ARCHS["encoder"])).init(5)
    assert torch.equal(a.encoder_cam.bias, torch.zeros(2))
    assert float(a.encoder.projector.weight.std()) > 0.5
    with pytest.raises(ValueError, match="use_encoder"):
        bridged("hybrid")[2](cond_img=torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError, match="sr_arch"):
        Ide3dGenerator(GeneratorConfig(**TINY, sr_arch="sg4"))


@torch.inference_mode()
def test_hybrid_table_carries_the_volume_and_sample_voxel_matches_jax(bridged):
    """plane_table holds the volume: a frame from it equals the uncached frame
    exactly, and dropping the volume changes it (the branch is wired in).
    sample_voxel with the volume against the JAX renderer's."""
    jG, params, G = bridged("hybrid")
    S = G.synthesis
    z = torch.from_numpy(np.random.RandomState(4).randn(1, 512).astype(np.float32))
    c = torch.from_numpy(_front())
    ws = G.mapping(z, c)
    table, volume = S.plane_table(ws)
    assert volume.shape == (1, 8, 8, 8, 8)
    uncached = S(ws, c)
    assert torch.equal(S(ws, c, table=(table, volume)), uncached)
    assert float((S(ws, c, table=(table, None)) - uncached).abs().max()) > 1e-4

    coords = np.random.RandomState(5).uniform(-1, 1, (1, 33, 3)).astype(np.float32)
    jws = jnp.asarray(ws.numpy())
    js = jG.synthesis
    img_v, seg_v = js.generate_planes(params["synthesis"], jws)
    jvol = js._feature_volume()(params["synthesis"]["feature_volume"], jws[:, 0])
    want = js.renderer.sample_voxel(params["synthesis"]["renderer"], img_v, seg_v,
                                    jnp.asarray(coords), volume=jvol)
    tv, sv = S.generate_planes(ws)
    got = S.renderer.sample_voxel(tv, sv, torch.from_numpy(coords), volume=S.volume(ws))
    _close("hybrid sample_voxel", got.numpy(), np.asarray(want))


@torch.inference_mode()
def test_fine_steps_render_matches_jax(bridged, monkeypatch):
    """num_steps 4, fine_steps 8 on the hybrid G: the frame against JAX's,
    and K1 composites halves of 4 and 8 samples."""
    jG, params, G = bridged("hybrid")
    rp = dict(img_size=8, num_steps=4, fine_steps=8)
    ws = np.asarray(jG.mapping(params["mapping"], jnp.asarray(np.random.RandomState(6).randn(
        1, 512).astype(np.float32)), jnp.asarray(_front())))
    want = jax.jit(lambda p, w, c: jG.synthesis(p, w, c, render_params=JRenderParams(**rp),
                                                return_all=True))(params["synthesis"], ws, _front())
    halves = []

    def spy(za, va, zb, vb, norm, **kw):
        halves.append((za.shape[2], zb.shape[2]))
        return ray_march.sort_integrate(za, va, zb, vb, norm, **kw)

    monkeypatch.setattr(trenderer, "sort_integrate", spy)
    got = G.synthesis(torch.from_numpy(ws.copy()), torch.from_numpy(_front()),
                      render_params=RenderParams(**rp), return_all=True)
    assert halves == [(4, 8)]
    for key in ("img", "seg_raw", "depth", "weights_sum"):
        _close(f"fine_steps {key}", got[key].numpy(), np.asarray(want[key]))
