"""The port's data parallelism (parallel/mesh.py, parallel/render.py and the
paths that use them) on gloo CPU ranks, against the JAX package's mesh.

Ranks are spawned once per world size for the module (tests/torch_parallel_ranks.py,
a file store in the module's temp dir, one intra-op thread each); the JAX
references run under jax.jit on the conftest's virtual CPU devices, with the
weights bridged by io/from_jax. Checks:
  * the ray-sharded frame at world 2 and 4 (tiny flagship and hybrid G)
    against JAX make_ray_sharded_frame on a 2- and 4-device mesh at rtol and
    atol 1e-5 (the JAX test's), and equal to the port's one-process
    G.synthesis exactly;
  * frame-sharded video chunks at world 2 equal to one process, bit for bit;
  * the global minibatch stddev under a group of 2 against JAX's on the
    global batch: values at 1e-6, first and second derivatives at 1e-5 x
    max|ref|;
  * a GAN train step (R1, PL, ADA at p 0.3) and an encoder step at global
    batch 4: world 2 against world 1 within 1e-5 x max|ref| for every
    parameter, Adam moment, w_avg, pl_mean and ADA p (only the reduction
    order differs; the encoder step's moments within 1e-3, see its test;
    tests/test_torch_parallel_float64.py holds both steps in float64 at
    1e-10); the replicas bit-equal, and unequal once one rank moves;
  * calc_metrics fid,kid (pixel detector) with --mesh-devices 2 against 1;
  * the loader's rank slices, a world that does not divide, and the no-jax
    imports of the new modules.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu import render as jrender
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models.discriminator import minibatch_stddev as jax_minibatch_stddev
from ide3d_tpu.parallel.mesh import create_mesh
from ide3d_tpu.parallel.render import make_ray_sharded_frame as jax_ray_sharded_frame
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.parallel import mesh
from ide3d_tpu_torch.parallel.render import make_frame_sharded_chunks, make_ray_sharded_frame
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_parallel_ranks import RankPool
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)
import torch_parallel_ranks as work

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
ARCHS = {"flagship": {}, "hybrid": dict(use_feature_volume=True, fv_resolution=8,
                                       fv_base_channels=16)}
STEP_TOL = 1e-5  # x max|ref|: world 2 against world 1, the reduction order alone differs
# x max|ref|: the port's frame against JAX's (the JAX test's 1e-5, as a share of
# the output's scale: the two packages' fp32 convolutions round differently)
JAX_TOL = 1e-5


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """pools(world) -> a RankPool of `world` gloo ranks, started once."""
    store = str(tmp_path_factory.mktemp("group_store"))
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world, store)
        return made[world]

    yield get
    for pool in made.values():
        pool.close()


@pytest.fixture(scope="module")
def bridged():
    """bridged(arch) -> (JAX G, its params, the port's G with those weights,
    ws [2, num_ws, 512], c [2, 25]), built once per module."""
    built = {}

    def get(arch):
        if arch not in built:
            rp = dict(img_size=8, num_steps=4, hierarchical=True)
            jG = JGenerator(JGeneratorConfig(**TINY, **ARCHS[arch], render=JRenderParams(**rp)))
            params = jax.jit(jG.init)(jax.random.PRNGKey(0))
            G = Ide3dGenerator(GeneratorConfig(**TINY, **ARCHS[arch], render=RenderParams(**rp)))
            load_jax_params(G, jax.tree_util.tree_map(np.asarray, params))
            z = np.random.RandomState(1).randn(2, 512).astype(np.float32)
            c = np.stack([np.asarray(jrender.CANONICAL_POSE_25, np.float32)] * 2)
            ws = np.asarray(jax.jit(jG.mapping)(params["mapping"], jnp.asarray(z), jnp.asarray(c)))
            built[arch] = (jG, params, G.eval(), ws, c)
        return built[arch]

    return get


def _sd(G):
    return {k: v.detach().numpy().copy() for k, v in G.state_dict().items()}


def _finite(*arrays):
    for a in arrays:
        assert np.isfinite(np.asarray(a, np.float64)).all(), "non-finite values"


def _close(name, got, ref, tol=STEP_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    _finite(got, ref)
    assert got.shape == ref.shape, f"{name}: {got.shape} != {ref.shape}"
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max abs err {err} > {tol} x {scale}"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["flagship", "hybrid"])
def test_ray_sharded_frame_matches_jax_mesh_and_one_process(pools, bridged, arch, world):
    jG, params, G, ws, c = bridged(arch)
    ref_img, ref_seg = jax_ray_sharded_frame(jG.synthesis, create_mesh(world))(
        params["synthesis"], jnp.asarray(ws), jnp.asarray(c))
    with torch.inference_mode():
        one_img, one_seg = G.synthesis(torch.from_numpy(ws), torch.from_numpy(c), return_seg=True)
    got = pools(world).run(work.ray_sharded_frame, G.cfg, _sd(G), ws, c)
    for rank, (img, seg, shapes) in enumerate(got):
        _finite(img, seg)
        # K1 once, on this rank's block of the 64 rays
        assert [s[:3] for s in shapes] == [(2, 64 // world, 4)], shapes
        _close("img vs JAX", img, ref_img, tol=JAX_TOL)
        _close("seg vs JAX", seg, ref_seg, tol=JAX_TOL)
        assert np.array_equal(img, one_img.numpy()), f"rank {rank}: img != one process"
        assert np.array_equal(seg, one_seg.numpy()), f"rank {rank}: seg != one process"


def test_frame_sharded_chunks_equal_one_process(pools, bridged):
    _, _, G, _, _ = bridged("flagship")
    rng = np.random.RandomState(5)
    z = torch.from_numpy(rng.randn(4, 512).astype(np.float32))
    c = torch.from_numpy(np.stack([np.asarray(jrender.CANONICAL_POSE_25, np.float32)] * 4))
    with torch.inference_mode():
        ws = G.mapping(z, c).numpy()
    one = make_frame_sharded_chunks(G.synthesis, work._video_post)(torch.from_numpy(ws), c)
    got = pools(2).run(work.frame_sharded_chunk, G.cfg, _sd(G), ws, c.numpy())
    for img8, depth, none in got:
        _finite(depth)
        assert none is None and img8.dtype == np.uint8 and img8.shape == (4, 32, 32, 3)
        assert np.array_equal(img8, one[0].numpy()) and np.array_equal(depth, one[1].numpy())


@pytest.mark.parametrize("world", [2])
def test_global_minibatch_stddev_and_its_derivatives_match_jax(pools, world):
    rng = np.random.RandomState(7)
    N, C, H, W, group_size = 8, 4, 4, 4, 4
    x, v = rng.randn(N, C, H, W).astype(np.float32), rng.randn(N, C + 1, H, W).astype(np.float32)
    u = rng.randn(N, C, H, W).astype(np.float32)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    f = lambda xx: (jax_minibatch_stddev(xx, group_size) * nhwc(v)).sum()
    g = jax.grad(f)
    y_ref = jax.jit(lambda xx: jax_minibatch_stddev(xx, group_size)[:, 0, 0, -1])(nhwc(x))
    g_ref = jax.jit(g)(nhwc(x))
    gg_ref = jax.jit(jax.grad(lambda xx: (g(xx) * nhwc(u)).sum()))(nhwc(x))
    got = pools(world).run(work.mbstd_and_derivatives, x, v, u, group_size)
    y, gx, ggx = (np.concatenate([r[i] for r in got]) for i in range(3))
    _finite(y, gx, ggx)
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=0, atol=1e-6)
    _close("d/dx", gx, np.asarray(g_ref).transpose(0, 3, 1, 2))
    _close("d2/dx2", ggx, np.asarray(gg_ref).transpose(0, 3, 1, 2))


def _gan_batch(b=4, R=32, seed=0):
    rng = np.random.RandomState(seed)
    c = np.stack([np.asarray(jrender.CANONICAL_POSE_25, np.float32)] * b)
    c[:, 3] += rng.uniform(-0.1, 0.1, b).astype(np.float32)  # distinct cameras for the swap
    return {"img": rng.randint(0, 256, (b, R, R, 3), np.uint8),
            "seg": rng.randint(0, 19, (b, R, R), np.uint8), "c": c}


def _same_trees(a, b, path="", tol=STEP_TOL):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_trees(a[k], b[k], f"{path}.{k}", tol)
    else:
        _close(path, a, b, tol)


def gan_step_check(pools, dtype, tol):
    """World 2 against world 1 after a tiny GAN step (R1, PL, ADA 0.3) in
    `dtype`: every state within tol x max|ref|, the replicas equal."""
    batch = _gan_batch()
    kw = dict(r1_interval=1, pl_weight=2.0)
    one, two = pools(1).submit(work.gan_steps, batch, kw, 0.3, 1, dtype), \
        pools(2).submit(work.gan_steps, batch, kw, 0.3, 1, dtype)
    ref, got = one.collect()[0], two.collect()
    assert ref["same"] and all(r["same"] for r in got), "replicas differ after the step"
    assert not any(r["perturbed"] for r in got), "a moved rank went unnoticed"
    assert next(iter(ref["G"].values())).dtype == np.dtype(dtype)
    for name in ("G", "D", "G_ema", "opt_g", "opt_d"):
        _same_trees(got[0][name], ref[name], name, tol)
    assert ref["pl_mean"] > 0 and ref["stats"]["r1_penalty"] > 0
    _close("pl_mean", got[0]["pl_mean"], ref["pl_mean"], tol)
    return ref, got


def test_gan_step_world_2_matches_world_1(pools):
    ref, got = gan_step_check(pools, "float32", STEP_TOL)
    assert got[0]["ada_p"] == got[1]["ada_p"] == ref["ada_p"] != 0.3
    for k, v in ref["stats"].items():  # the accumulator reads the global batch's stats
        assert got[0]["stats"][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def encoder_step_runs(pools, dtype):
    """World 1's and world 2's encoder step in `dtype` (rank 0's state, every
    rank's replica check)."""
    batch = _gan_batch(R=16, seed=4)
    one, two = pools(1).submit(work.encoder_steps, batch, 1, dtype), \
        pools(2).submit(work.encoder_steps, batch, 1, dtype)
    ref, got = one.collect()[0], two.collect()
    assert all(r["same"] for r in got), "replicas differ after the step"
    assert next(iter(ref["E"].values())).dtype == np.dtype(dtype)
    return ref, got


def adam_first_update(m, v, adam) -> np.ndarray:
    """Adam's first update of a parameter (torch's formula, in float64) from
    its moments after the step; `adam`: the optimizer's lr, betas and eps."""
    (b1, b2), m, v = adam["betas"], np.asarray(m, np.float64), np.asarray(v, np.float64)
    return adam["lr"] * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + adam["eps"])


def test_encoder_step_world_2_matches_world_1(pools):
    """Adam's moments (the averaged gradients) within 1e-3 of each tensor's
    max: at this random init the first convolutions' gradients are sums of
    far larger per-sample terms, and the ranks' batch of 2 against one
    process's 4 sums them in another order; 3.6e-4 of its max read in
    img.block0.conv1.bias, the rest below 3.4e-5, and 1.2e-14 in float64
    (tests/test_torch_parallel_float64.py), so the gap is rounding. The
    parameters: from equal weights, their gap must be the gap of Adam's
    first updates made of the two runs' own moments, within 1e-5 x
    max|param|, for every element. (A step's update is about lr * sign(g),
    and lr * g / (|g| + eps) where |g| nears eps: where |g| lies within the
    moments' gap, or near eps, that gap moves the element by up to 2 lr.)"""
    ref, got = encoder_step_runs(pools, "float32")
    mine = got[0]
    for name, m_ref in ref["opt_e"].items():
        _close(f"opt_e.{name}", mine["opt_e"][name], m_ref, tol=1e-3)
    for name, p_ref in ref["E"].items():
        u = {k: adam_first_update(r["opt_e"][f"{name}.exp_avg"], r["opt_e"][f"{name}.exp_avg_sq"],
                                  r["adam"]) for k, r in (("ref", ref), ("got", mine))}
        gap = (mine["E"][name].astype(np.float64) - p_ref) + (u["got"] - u["ref"])
        _finite(gap)
        err = float(np.abs(gap).max())
        assert err <= STEP_TOL * float(np.abs(p_ref).max()), (name, err)


def _write_dataset(root, n=8, R=32):
    import PIL.Image

    rng = np.random.RandomState(2)
    imgs, segs = os.path.join(root, "imgs"), os.path.join(root, "segs")
    os.makedirs(imgs)
    os.makedirs(segs)
    labels = []
    for i in range(n):
        name = f"{i:04d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(os.path.join(imgs, name))
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(os.path.join(segs, name))
        labels.append([name, list(np.asarray(jrender.CANONICAL_POSE_25, float))])
    with open(os.path.join(imgs, "dataset.json"), "w") as f:
        json.dump({"labels": labels}, f)
    return imgs


def test_calc_metrics_mesh_devices_2_equals_1(tmp_path, monkeypatch):
    from threadpoolctl import threadpool_limits

    from ide3d_tpu_torch.apps import calc_metrics

    # FID's sqrtm at the pixel detector's 1024 features: 3 s at one BLAS
    # thread, 12 s at eight on a shared CPU (here and in the spawned ranks)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    imgs = _write_dataset(str(tmp_path))
    runs = {}
    for n in (1, 2):
        run_dir = str(tmp_path / f"run{n}")
        with threadpool_limits(1):
            calc_metrics.main(["--network", "random:0:tiny", "--data", imgs, "--metrics",
                               "fid,kid", "--detector", "pixel", "--num-items", "8", "--batch",
                               "4", "--cache-dir", str(tmp_path / f"cache{n}"), "--run-dir",
                               run_dir, "--mesh-devices", str(n), "--device", "cpu"])
        runs[n] = {m: json.loads(open(os.path.join(run_dir, f"metric-{m}.jsonl")).read())
                   ["results"][m] for m in ("fid", "kid")}
    _finite(list(runs[1].values()))
    for m in ("fid", "kid"):
        assert runs[2][m] == pytest.approx(runs[1][m], rel=1e-5, abs=1e-6), (m, runs)


def test_loader_ranks_read_the_one_process_batches(pools, tmp_path):
    _write_dataset(str(tmp_path), n=6)
    p1, p2 = pools(1).submit(work.loader_rows, str(tmp_path), 4, 5), \
        pools(2).submit(work.loader_rows, str(tmp_path), 4, 5)
    one, two = p1.collect()[0], p2.collect()
    for i, ref in enumerate(one):
        for k in ref:
            assert np.array_equal(np.concatenate([two[0][i][k], two[1][i][k]]), ref[k]), (i, k)


def test_a_world_that_does_not_divide_is_refused(bridged, monkeypatch):
    _, _, G, _, _ = bridged("flagship")
    three = mesh.Group(rank=0, size=3)
    with pytest.raises(ValueError, match="not divisible"):
        make_ray_sharded_frame(G.synthesis, three)  # 64 rays
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(three, {"c": torch.zeros(4, 25)})
    assert mesh.dp_world(6, "cpu") == 1
    # under torchrun: the largest world that divides the batch, as the JAX apps
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert mesh.dp_world(4, "cuda") == 2 and mesh.dp_world(6, "cpu") == 3


def test_new_modules_import_no_jax(pools):
    mods = ("parallel.mesh", "parallel.render", "parallel.stats", "utils.profiling",
            "apps.train_gan", "apps.train_hybrid_encoder", "apps.calc_metrics",
            "apps.gen_videos")
    assert pools(1).run(work.imports_leave_jax_out, mods) == [False]
