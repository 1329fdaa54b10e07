"""Gloo ranks for the port's data-parallel CPU tests, and the work they run.

A `RankPool` starts `world` spawned processes once, each one rank of a gloo
group initialised through a file store, at one intra-op thread; `run(fn,
*args)` calls fn(group, *args) on every rank and returns the ranks' results
in rank order (a rank's exception fails the call with its traceback);
`submit` and `collect` split a run so that two pools work at once. The
task functions live here, importable without JAX, and take and return numpy.
"""

from __future__ import annotations

import contextlib
import os
import traceback

import torch

TASK_TIMEOUT_S = 240


def _rank_main(rank, world, init_method, tasks, results):
    torch.set_num_threads(1)
    from ide3d_tpu_torch.parallel import mesh

    group = mesh.create_group("cpu", rank, world, init_method)
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            fn, args = item
            try:
                results.put((rank, True, fn(group, *args)))
            except BaseException:  # reported to the test, which fails with it
                results.put((rank, False, traceback.format_exc()))
    finally:
        mesh.destroy_group(group)


class RankPool:
    def __init__(self, world: int, store_dir: str):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        init = "file://" + os.path.join(store_dir, f"store_{world}")
        self.procs = [ctx.Process(target=_rank_main, args=(r, world, init, self.tasks[r],
                                                           self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def submit(self, fn, *args) -> "RankPool":
        """Start fn(group, *args) on every rank; `collect` returns the results
        (two pools run their tasks at once)."""
        for q in self.tasks:
            q.put((fn, args))
        return self

    def run(self, fn, *args):
        return self.submit(fn, *args).collect()

    def collect(self):
        got = {}
        for _ in range(self.world):
            rank, ok, value = self.results.get(timeout=TASK_TIMEOUT_S)
            if not ok:
                raise RuntimeError(f"rank {rank} of {self.world} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


# ---------------------------------------------------------------- the work


@contextlib.contextmanager
def compute_dtype(name: str):
    """Run the port's fp32 compute in `name` ('float32': as it is; 'float64':
    the default dtype, the models' 'float32' compute dtype and Tensor.float,
    the fp32 epilogues' cast, all made float64) for one task: the float64
    run is the witness that a gap between worlds is fp32 rounding of a
    different reduction order, not a fault across ranks."""
    if name == "float32":
        yield
        return
    from ide3d_tpu_torch.models import blocks

    saved = torch.get_default_dtype(), blocks.DTYPES["float32"], torch.Tensor.float
    torch.set_default_dtype(torch.float64)
    blocks.DTYPES["float32"] = torch.float64
    torch.Tensor.float = lambda self, *args, **kw: self.double()
    try:
        yield
    finally:
        torch.set_default_dtype(saved[0])
        blocks.DTYPES["float32"] = saved[1]
        torch.Tensor.float = saved[2]


def _state_dict(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module


def make_g(cfg, sd: dict):
    from ide3d_tpu_torch.models.generator import Ide3dGenerator

    return _load(Ide3dGenerator(cfg), sd).eval()


def ray_sharded_frame(group, cfg, sd, ws, c):
    """The port's ray-sharded frame of the bridged G on this group, with the
    K1 launches of this rank and the row count of its K1 input."""
    from ide3d_tpu_torch.ops import ray_march
    from ide3d_tpu_torch.parallel.render import make_ray_sharded_frame
    from ide3d_tpu_torch.render import renderer

    G = make_g(cfg, sd)
    shapes = []

    def spy(*args, **kw):
        shapes.append(tuple(args[1].shape))
        return ray_march.sort_integrate(*args, **kw)

    renderer.sort_integrate = spy
    try:
        img, seg = make_ray_sharded_frame(G.synthesis, group)(torch.from_numpy(ws),
                                                              torch.from_numpy(c))
    finally:
        renderer.sort_integrate = ray_march.sort_integrate
    return img.numpy(), seg.numpy(), shapes


def _video_post(out):
    img8 = torch.round((out["img"] + 1) * 127.5).clamp(0, 255).to(torch.uint8)
    return img8, out["depth"], None


def frame_sharded_chunk(group, cfg, sd, ws, c):
    from ide3d_tpu_torch.parallel.render import make_frame_sharded_chunks

    G = make_g(cfg, sd)
    img8, depth, none = make_frame_sharded_chunks(G.synthesis, _video_post, group)(
        torch.from_numpy(ws), torch.from_numpy(c))
    return img8.numpy(), depth.numpy(), none


def mbstd_and_derivatives(group, x, v, u, group_size):
    """This rank's rows of the global minibatch stddev's appended channel, of
    the gradient of sum(out * v) and of the gradient of sum(grad * u)."""
    from ide3d_tpu_torch.models.discriminator import minibatch_stddev
    from ide3d_tpu_torch.parallel.mesh import rows

    mine = rows(group, x.shape[0])
    xl = torch.from_numpy(x[mine]).requires_grad_()
    with torch.enable_grad():
        out = minibatch_stddev(xl, group_size, 1, group)
        (g,) = torch.autograd.grad((out * torch.from_numpy(v[mine])).sum(), xl, create_graph=True)
        (gg,) = torch.autograd.grad((g * torch.from_numpy(u[mine])).sum(), xl)
    return out[:, -1, 0, 0].detach().numpy(), g.detach().numpy(), gg.numpy()


def _tiny_gan(tcfg):
    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.train import gan

    G = Ide3dGenerator(PRESETS["tiny"]).init(0)
    D = Discriminator(DiscriminatorConfig(img_resolution=32, img_channels=25, channel_base=512,
                                          channel_max=32, dtype="float32")).init(1)
    return gan.init_gan_state(G, D, tcfg)


def _opt_moments(opt, module) -> dict:
    """Adam's moments of each parameter of `module`, by its name."""
    return {f"{name}.{k}": opt.state[p][k].numpy().copy()
            for name, p in module.named_parameters() for k in ("exp_avg", "exp_avg_sq")}


def gan_steps(group, batch, tcfg_kw, ada_p, steps, dtype="float32"):
    """`steps` train steps of the tiny G and D on this rank's rows of the
    global batch, computed in `dtype`; returns the networks, Adam moments,
    w_avg, pl_mean, the ADA p after the sign statistics' update, the replica
    check before and after perturbing rank 1's D, and the stats the
    accumulator reads."""
    with compute_dtype(dtype):
        return _gan_steps(group, batch, tcfg_kw, ada_p, steps)


def _gan_steps(group, batch, tcfg_kw, ada_p, steps):
    from ide3d_tpu_torch.parallel.mesh import shard_batch
    from ide3d_tpu_torch.parallel.stats import StatsAccumulator
    from ide3d_tpu_torch.train import gan
    from ide3d_tpu_torch.train.augment import AdaState, ada_accumulate, ada_update
    from ide3d_tpu_torch.utils.profiling import check_replica_consistency

    tcfg = gan.GanTrainConfig(**tcfg_kw)
    state = _tiny_gan(tcfg)
    step = gan.make_gan_train_step(tcfg, group)
    gen = torch.Generator().manual_seed(1)
    local = shard_batch(group, {k: torch.from_numpy(v) for k, v in batch.items()})
    acc, ada = StatsAccumulator(group), AdaState(p=ada_p, rt_accum=(0.0, 0.0))
    for _ in range(steps):
        state, stats = step(state, local, gen, ada_p)
        acc.update(stats)
        ada = ada_accumulate(ada, stats["real_signs"], batch["c"].shape[0], group)
    ada = ada_update(ada, batch["c"].shape[0] * steps, speed_kimg=0.01)
    same = check_replica_consistency(group, state.G, state.D, state.G_ema)
    if group.rank == 1:
        with torch.no_grad():
            state.D.b4.out.weight[0, 0] += 1e-3
    perturbed = check_replica_consistency(group, state.G, state.D, state.G_ema)
    return {"G": _state_dict(state.G), "D": _state_dict(state.D),
            "G_ema": _state_dict(state.G_ema), "opt_g": _opt_moments(state.opt_g, state.G),
            "opt_d": _opt_moments(state.opt_d, state.D), "pl_mean": float(state.pl_mean),
            "ada_p": ada.p, "same": same, "perturbed": perturbed, "stats": acc.as_dict()}


def encoder_steps(group, batch, steps, dtype="float32"):
    """`steps` encoder steps (both branches) of a 16² tiny G at w_dim 64 and
    its HybridEncoder on this rank's rows of the global batch, in `dtype`;
    rank 0 returns the encoder, its Adam moments and Adam's lr, betas and
    eps, every rank the replica check."""
    with compute_dtype(dtype):
        return _encoder_steps(group, batch, steps)


def _encoder_steps(group, batch, steps):
    import dataclasses

    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.models.encoder import HybridEncoder
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.parallel.mesh import shard_batch
    from ide3d_tpu_torch.train import encoder as tenc
    from ide3d_tpu_torch.utils.profiling import check_replica_consistency

    cfg = dataclasses.replace(PRESETS["tiny"], img_resolution=16, z_dim=64, w_dim=64)
    G = Ide3dGenerator(cfg).init(0).requires_grad_(False)
    n_geo = G.synthesis.num_ws_geo
    E = HybridEncoder(size=16, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo,
                      w_dim=64).init(0)
    tcfg = tenc.EncoderTrainConfig()
    state = tenc.init_encoder_state(E, tcfg)
    step = tenc.make_encoder_train_step(E, G, tcfg, group=group)
    gen = torch.Generator().manual_seed(2)
    local = shard_batch(group, {k: torch.from_numpy(v) for k, v in batch.items()})
    for _ in range(steps):
        state, stats = step(state, local, gen)
    out = {"same": check_replica_consistency(group, state.E),
           "loss_total": float(stats["loss_total"])}
    if group.is_main:  # the replicas are equal: one rank's 25M-parameter state is enough
        out.update(E=_state_dict(state.E), opt_e=_opt_moments(state.opt_e, state.E),
                   adam={k: state.opt_e.param_groups[0][k] for k in ("lr", "betas", "eps")})
    return out


def loader_rows(group, root, batch, n_batches):
    from ide3d_tpu_torch.data.dataset import CameraLabeledDataset, infinite_loader
    from ide3d_tpu_torch.parallel.mesh import prefetch_to_device

    ds = CameraLabeledDataset(os.path.join(root, "imgs"), os.path.join(root, "segs"),
                              resolution=32, xflip=True)
    it = prefetch_to_device(infinite_loader(ds, batch, seed=3, rank=group.rank,
                                            world_size=group.size), "cpu")
    out = [{k: v.numpy() for k, v in next(it).items()} for _ in range(n_batches)]
    it.close()
    return out


def imports_leave_jax_out(group, modules):
    """Import the port's modules in this rank, a process that never imported
    JAX; whether JAX or the JAX package came in with them."""
    import importlib
    import sys

    for m in modules:
        importlib.import_module(f"ide3d_tpu_torch.{m}")
    return any(m == "jax" or m.startswith(("jax.", "ide3d_tpu.")) for m in sys.modules)
