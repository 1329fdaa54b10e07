"""The port's serving artifact (io/export.py, apps/export_model.py) and K1's
operator, on the CPU, against the port's eager G and the JAX package.

The JAX export test's tiny G (tests/test_misc_utils.py) is initialised by JAX
and bridged into the port through io/from_jax.py; its artifact is written
once for the module.
"""

import json
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
from ide3d_tpu_torch.apps import export_model
from ide3d_tpu_torch.io import export_generator, load_artifact
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.ops import ray_march
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_resolution=64, render_size=16, plane_resolution=32, channel_base=2048,
            channel_max=64, sr_channel_base=1024, sr_channel_max=32, feature_channels=8,
            dtype="float32")
TRUNC = 0.7
ATOL = 2e-4  # tests/test_torch_generator.py's tolerance against the JAX G
# the keys of the JAX package's meta.json (ide3d_tpu/io/export.py)
META_KEYS = {"format", "batch", "z_dim", "c_dim", "w_dim", "num_ws", "img_resolution",
             "truncation_psi", "return_seg", "render", "platforms"}


LOAD_AND_RENDER = """
import json, sys, numpy as np, torch
from ide3d_tpu_torch.io.export import load_artifact
out, tmp = sys.argv[1:]
art = load_artifact(out, device="cpu")
z, c = (torch.from_numpy(np.load(f"{tmp}/{k}.npy")) for k in ("z", "c"))
ws = art.map_z(z, c)
img, seg = art.render(ws, c)
for k, v in (("ws", ws), ("img", img), ("seg", seg)):
    np.save(f"{tmp}/{k}.npy", v.numpy())
print(json.dumps({
    "k1_nodes": sum("ide3d_tpu_torch.sort_integrate" in str(n.target)
                    for n in art._frame.graph.nodes if n.op == "call_function"),
    "flrelu_nodes": sum("ide3d_tpu_torch.filtered_lrelu" in str(n.target)
                        for n in art._frame.graph.nodes if n.op == "call_function"),
    "metadata_asserts": sum("_assert_tensor_metadata" in str(n.target)
                            for m in (art._mapping, art._frame) for n in m.graph.nodes),
    "imported": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ide3d_tpu")
                       or m.startswith("ide3d_tpu_torch.models")),
}))
"""


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """(the JAX G's outputs, the port's eager outputs, the artifact's dir and
    the outputs of its programs), all on one z and the canonical pose. A fresh
    process loads the artifact and renders (LOAD_AND_RENDER)."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=16, num_steps=8,
                                                                  hierarchical=True)))
    params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=16, num_steps=8)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, params))
    G.eval()

    z = np.random.RandomState(1).randn(1, G.z_dim).astype(np.float32)
    c = np.asarray(jrender.CANONICAL_POSE_25, np.float32)[None]

    @jax.jit
    def jax_frame(p, z, c):
        ws = jG.mapping(p["mapping"], z, c, truncation_psi=TRUNC)
        return (ws, *jG.synthesis(p["synthesis"], ws, c, return_seg=True))

    ref = [np.asarray(x) for x in jax_frame(params, jnp.asarray(z), jnp.asarray(c))]

    zt, ct = torch.from_numpy(z), torch.from_numpy(c)
    with torch.no_grad():
        ws = G.mapping(zt, ct, truncation_psi=TRUNC)
        eager = (ws, *G.synthesis(ws, ct, return_seg=True))

    out = str(tmp_path_factory.mktemp("artifact"))
    tmp = str(tmp_path_factory.mktemp("io"))
    meta = export_generator(G, out, truncation_psi=TRUNC)
    np.save(f"{tmp}/z.npy", z)
    np.save(f"{tmp}/c.npy", c)
    proc = subprocess.run([sys.executable, "-c", LOAD_AND_RENDER, out, tmp], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    got = [torch.from_numpy(np.load(f"{tmp}/{k}.npy")) for k in ("ws", "img", "seg")]
    yield {"ref": ref, "eager": eager, "got": got, "dir": out, "meta": meta,
           "num_ws": jG.num_ws, "loaded": json.loads(proc.stdout.splitlines()[-1])}
    import shutil

    for d in (out, tmp):
        shutil.rmtree(d, ignore_errors=True)


def test_artifact_equals_eager_g(artifact):
    """map_z and render of the CPU artifact equal the port's eager
    G.mapping(truncation_psi=0.7) and G.synthesis(return_seg=True) bit for bit."""
    for name, got, want in zip(("ws", "img", "seg"), artifact["got"], artifact["eager"]):
        assert torch.isfinite(got).all(), name
        assert got.shape == want.shape, name
        assert torch.equal(got, want), f"{name}: max |diff| {(got - want).abs().max()}"


def test_artifact_matches_jax(artifact):
    """The artifact against the JAX package's live jitted mapping and synthesis."""
    for name, got, want in zip(("ws", "img", "seg"), artifact["got"], artifact["ref"]):
        got = got.numpy()
        assert np.isfinite(got).all(), name
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=name)


def test_artifact_layout_and_meta(artifact):
    """The directory holds one program pair for the CPU and meta.json with the
    JAX package's keys; the frame records K1 as one operator node, and
    neither program keeps torch.export's per-cast metadata asserts."""
    out, meta = artifact["dir"], artifact["meta"]
    assert sorted(os.listdir(out)) == ["frame.cpu.pt2", "mapping.cpu.pt2", "meta.json"]
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f) == meta
    assert set(meta) == META_KEYS
    assert meta["format"] == "ide3d_tpu_torch.export/1" and meta["platforms"] == ["cpu"]
    assert (meta["num_ws"], meta["truncation_psi"], meta["render"]) == (
        artifact["num_ws"], TRUNC, {"img_size": 16, "num_steps": 8, "fine_steps": None})
    assert artifact["loaded"]["k1_nodes"] == 1
    assert artifact["loaded"]["metadata_asserts"] == 0


def test_artifact_loads_without_model_code(artifact):
    """The process that loaded and rendered the artifact imported none of the
    port's models, no jax and nothing of ide3d_tpu."""
    assert artifact["loaded"]["imported"] == []


def test_artifact_refuses_a_platform_it_lacks(artifact, monkeypatch):
    """load_artifact(device="cuda") on a CPU-only artifact raises before it
    loads a program or touches CUDA."""
    def refuse(*args, **kw):
        raise AssertionError("touched CUDA or loaded a program")

    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    monkeypatch.setattr(torch.export, "load", refuse)
    with pytest.raises(ValueError, match="none for cuda"):
        load_artifact(artifact["dir"], device="cuda")


def test_sg3_artifact_records_filtered_lrelu_as_operators(tmp_path):
    """A tiny SG3 G's CPU artifact: its frame records each of the stack's
    filtered_lrelu calls (its layers and ToRGB) as one operator node; a fresh process that imports
    no model code loads it and renders the eager G's frame bit for bit."""
    G = Ide3dGenerator(GeneratorConfig(**TINY, sr_arch="sg3",
                                       render=RenderParams(img_size=16, num_steps=8)))
    G = G.init(seed=0).eval()
    z = np.random.RandomState(1).randn(1, G.z_dim).astype(np.float32)
    c = np.asarray(jrender.CANONICAL_POSE_25, np.float32)[None]
    with torch.no_grad():
        ws = G.mapping(torch.from_numpy(z), torch.from_numpy(c), truncation_psi=TRUNC)
        eager = (ws, *G.synthesis(ws, torch.from_numpy(c), return_seg=True))
    out, tmp = str(tmp_path / "artifact"), str(tmp_path / "io")
    os.makedirs(tmp)
    export_generator(G, out, truncation_psi=TRUNC)
    np.save(f"{tmp}/z.npy", z)
    np.save(f"{tmp}/c.npy", c)
    proc = subprocess.run([sys.executable, "-c", LOAD_AND_RENDER, out, tmp], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.splitlines()[-1])
    calls = G.synthesis.sg3_sr.num_layers + 1
    assert (loaded["flrelu_nodes"], loaded["k1_nodes"], loaded["imported"]) == (calls, 1, [])
    for name, want in zip(("ws", "img", "seg"), eager):
        got = torch.from_numpy(np.load(f"{tmp}/{name}.npy"))
        assert torch.equal(got, want), f"{name}: max |diff| {(got - want).abs().max()}"


@pytest.mark.parametrize("noise", [False, True])
def test_k1_operator(noise):
    """torch.library.opcheck on K1's operator (schema, fake shapes, dispatch)
    at small CPU shapes, fp32 and bf16 values; its CPU implementation equals
    sort_integrate_plain exactly."""
    gen = torch.Generator().manual_seed(0)
    B, R, s_a, s_b, c1 = 2, 8, 5, 7, 6
    z_a = (torch.rand(B, R, s_a, 1, generator=gen) * 2 + 1).sort(dim=2).values
    z_b = torch.rand(B, R, s_b, 1, generator=gen) * 2 + 1
    v_a = torch.randn(B, R, s_a, c1, generator=gen)
    v_b = torch.randn(B, R, s_b, c1, generator=gen)
    ray_norm = torch.rand(B, R, 1, generator=gen) + 0.5
    nz = torch.randn(B, R, s_a + s_b, generator=gen) if noise else None
    op = torch.ops.ide3d_tpu_torch.sort_integrate
    for vals, opts in (((v_a, v_b), ("softplus", False, True)),
                       ((v_a.bfloat16(), v_b.bfloat16()), ("relu", True, False))):
        args = (z_a, vals[0], z_b, vals[1], ray_norm, nz, *opts)
        torch.library.opcheck(op.default, args)
        got = op(*args)
        want = ray_march.sort_integrate_plain(
            z_a, vals[0], z_b, vals[1], ray_norm, noise=nz, clamp_mode=opts[0],
            last_back=opts[1], white_back=opts[2])
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
    assert ray_march.sort_integrate.launches == 0  # the plain version never counts


def test_export_model_cli(tmp_path, capsys):
    """export_model --network random:0:tiny --device cpu --check writes the CPU
    program pair and meta.json and renders a finite frame from them."""
    out = str(tmp_path / "art")
    assert export_model.main(["--network", "random:0:tiny", "--device", "cpu", "--outdir", out,
                              "--trunc", "0.7", "--check"]) == 0
    assert sorted(os.listdir(out)) == ["frame.cpu.pt2", "mapping.cpu.pt2", "meta.json"]
    assert "check (cpu): rendered (1, 32, 32, 3), finite=True" in capsys.readouterr().out
