"""The PyTorch port's generator against the JAX package, on the CPU.

The tiny generator of tests/test_golden.py is initialised by JAX, bridged into
the port through io/from_jax.py, and must reproduce tests/golden_tiny_g.npz.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu import render as jrender
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu_torch.apps import gen_images
from ide3d_tpu_torch.apps.common import PRESETS, load_generator
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.render.renderer import RenderParams

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_tiny_g.npz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
ATOL = 2e-4  # the golden test's own tolerance


@pytest.fixture(scope="module")
def bridged_tiny():
    """(JAX G, its params from PRNGKey(0), the port's G holding the same weights)."""
    jcfg = JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4, hierarchical=True))
    jG = JGenerator(jcfg)
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, params))
    return jG, params, G.eval()


def _assert_close(name, got, ref, atol=ATOL):
    got = np.asarray(got)
    assert np.isfinite(got).all(), f"{name}: non-finite values"
    assert got.shape == ref.shape, f"{name}: shape {got.shape} != {ref.shape}"
    np.testing.assert_allclose(got, ref, atol=atol, rtol=atol, err_msg=name)


@torch.inference_mode()
def test_bridged_tiny_generator_reproduces_golden(bridged_tiny):
    _, _, G = bridged_tiny
    ref = np.load(GOLDEN_PATH)
    z = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(42), (1, 512))))
    c = torch.from_numpy(np.array(jrender.CANONICAL_POSE_25))[None]
    coords = torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(7), (1, 32, 3), minval=-0.5, maxval=0.5)))

    out = G(z, c, return_all=True)
    ws = G.mapping(z, c)
    img_v, seg_v = G.synthesis.generate_planes(ws)
    voxel = G.synthesis.renderer.sample_voxel(img_v, seg_v, coords)
    for key, got in (("img", out["img"]), ("seg_raw", out["seg_raw"]), ("depth", out["depth"]),
                     ("ws", ws), ("voxel", voxel)):
        _assert_close(key, got.numpy(), ref[key])


@torch.inference_mode()
def test_bridged_tiny_generator_matches_jax_outputs(bridged_tiny):
    """Every output of return_all, plus the upsampled seg, against the JAX G."""
    jG, params, G = bridged_tiny
    rng = np.random.RandomState(3)
    z = rng.randn(2, 512).astype(np.float32)
    c = np.stack([np.asarray(jrender.CANONICAL_POSE_25)] * 2)
    ref = jax.jit(lambda p, z, c: jG(p, z, c, return_all=True, truncation_psi=0.7))(
        params, jnp.asarray(z), jnp.asarray(c))
    got = G(torch.from_numpy(z), torch.from_numpy(c), return_all=True, truncation_psi=0.7)
    for key in ("img", "img_raw", "seg", "seg_raw", "depth", "weights_sum"):
        _assert_close(key, got[key].numpy(), np.asarray(ref[key]))


def test_init_is_seeded():
    a = Ide3dGenerator(PRESETS["tiny"]).init(5).state_dict()
    b = Ide3dGenerator(PRESETS["tiny"]).init(5).state_dict()
    c = Ide3dGenerator(PRESETS["tiny"]).init(6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["synthesis.vb4.const"], c["synthesis.vb4.const"])
    assert torch.equal(a["synthesis.vb4.conv.affine.bias"], torch.ones(32))  # bias_init 1


def test_gen_images_cli_writes_pngs(tmp_path):
    gen_images.main(["--network", "random:0:tiny", "--seeds", "1", "--num-steps", "4",
                     "--outdir", str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == ["seed0001.png", "seed0001_seg.png"]


@torch.inference_mode()
def test_synth_views_batch_of_three_yaws():
    G = load_generator("random:0:tiny", device="cpu")
    rp = RenderParams(img_size=8, num_steps=4)
    ws = G.mapping(torch.randn(1, 512, generator=torch.Generator().manual_seed(0)),
                   torch.as_tensor(jrender.CANONICAL_POSE_25)[None])
    cams = gen_images.yaw_cameras()
    img, seg, seg_rgb = gen_images.synth_views(G, ws, cams, rp)
    assert img.shape == (3, 32, 32, 3) and seg.shape == (3, 32, 32, 19)
    assert seg_rgb.shape == (3, 32, 32, 3)
    assert torch.isfinite(img).all() and torch.isfinite(seg).all()
    # the three yaws see the head from different sides
    assert not torch.allclose(img[0], img[2])


@torch.inference_mode()
def test_noise_modes_and_generator():
    """'random' draws layer noise (and depth jitter) from the generator: the same
    seed repeats, another seed differs; 'const' and 'none' need no generator."""
    G = load_generator("random:0:tiny", device="cpu")
    for name, p in G.named_parameters():  # non-zero noise so that the modes differ
        if name.endswith("noise_strength"):
            p.fill_(0.5)
    ws = G.mapping(torch.randn(2, 512, generator=torch.Generator().manual_seed(1)),
                   torch.as_tensor(jrender.CANONICAL_POSE_25)[None].expand(2, -1))
    c = torch.as_tensor(jrender.CANONICAL_POSE_25)[None].expand(2, -1)

    def run(mode, seed=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return G.synthesis(ws, c, noise_mode=mode, generator=gen)

    a, b, other = run("random", 3), run("random", 3), run("random", 4)
    const, none = run("const"), run("none")
    assert all(torch.isfinite(x).all() for x in (a, other, const, none))
    assert torch.equal(a, b) and not torch.allclose(a, other)
    assert not torch.allclose(const, none) and not torch.allclose(a, const)
    with pytest.raises(ValueError):
        run("random")


def test_yaw_cameras_match_jax():
    import math

    ref = np.concatenate([
        np.asarray(jrender.make_label_25(
            jrender.look_at_pose(y + math.pi / 2, math.pi / 2, [0.0, 0.0, 0.0], radius=2.7)))
        for y in gen_images.YAWS])
    _assert_close("cams", gen_images.yaw_cameras().numpy(), ref, atol=1e-6)


def test_import_leaves_jax_out():
    code = ("import sys, ide3d_tpu_torch, ide3d_tpu_torch.apps.gen_images, "
            "ide3d_tpu_torch.io.from_jax; print('jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "False"
