"""GAN training: the step of `train.gan.make_gan_train_step` in train_gan's loop.

The traffic file's parameters: the batch, a pool of `pool` synthetic items
(uint8 RGB, 19-class ids in 16x16-pixel blocks, cameras around the front)
made on the device from the seed and taken `batch` rows at a time in turn,
ADA at a fixed p, R1 every `r1_interval` steps at the gamma of train_gan's
heuristic (0.0002 R^2 / batch). Each window unit is one R1
cycle (r1_interval steps, one of them with R1), so that every window holds
R1 in its share.

Set-up builds the training state once and drives it through its first three
steps (step 0 takes R1); the window continues the same state. For the check,
the program's losses of those steps, its first gradients (Adam's first moment
after step 0, with beta1 = 0 the gradient itself), its parameters before
step 0, after step 0 and after step 2, and G_ema's parameters and both w_avg
buffers before and after step 0 are kept; once the window has closed,
the frozen reference (reference/frozen) takes the same three steps from the
same weights, draws and batches in float32.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from .. import weights
from ..reference import generator as ref
from . import common
from .common import look_at_label

CHECK_STEPS = 3


def train_configs(run, frozen: bool = False, dtype: str = None):
    """(GeneratorConfig, DiscriminatorConfig, GanTrainConfig) of the run, from
    the program or, with `frozen`, from the frozen reference; `dtype` in
    place of the configuration's compute dtype."""
    if frozen:
        from ..reference.frozen import augment, discriminator, gan, generator, renderer
    else:
        from ide3d_tpu_torch.models import discriminator, generator
        from ide3d_tpu_torch.render import renderer
        from ide3d_tpu_torch.train import augment, gan
    tr = run.traffic
    g = dict(run.config["generator"])
    rp = dict(g["render"], pixel_offset=tuple(g["render"]["pixel_offset"]))
    g["render"] = renderer.RenderParams(**rp)
    d = dict(run.config["discriminator"])
    if dtype is not None:
        g["dtype"] = d["dtype"] = dtype
    aug = {"compute_dtype": g["dtype"]}  # ADA's stack computes in G's dtype, bf16 by default
    gamma = 0.0002 * g["img_resolution"] ** 2 / tr["batch"]
    tcfg = gan.GanTrainConfig(r1_gamma=gamma, r1_interval=tr["r1_interval"],
                              pl_weight=tr["pl_weight"], aug=augment.AugmentConfig(**aug))
    return generator.GeneratorConfig(**g), discriminator.DiscriminatorConfig(**d), tcfg


def data_pool(run) -> dict:
    """`pool` items on the device from the seed: img uint8 [N, R, R, 3], seg
    uint8 class ids [N, R, R], c [N, 25] at yaw in [-0.5, 0.5], pitch in [-0.2, 0.2]."""
    tr, dev = run.traffic, torch.device(run.device)
    n, R = tr["pool"], run.config["generator"]["img_resolution"]
    gen = torch.Generator(device=dev).manual_seed((run.seed + 3) % weights.SEED_MOD)
    img = torch.randint(0, 256, (n, R, R, 3), generator=gen, device=dev, dtype=torch.uint8)
    blocks = torch.randint(0, run.config["generator"]["seg_channels"], (n, R // 16, R // 16),
                           generator=gen, device=dev, dtype=torch.uint8)
    seg = blocks.repeat_interleave(16, 1).repeat_interleave(16, 2)
    rng = np.random.default_rng([run.seed, 3])
    c = np.stack([look_at_label(rng.uniform(-0.5, 0.5), rng.uniform(-0.2, 0.2)) for _ in range(n)])
    return {"img": img, "seg": seg, "c": torch.as_tensor(c, device=dev)}


def batch_of(pool: dict, i: int, B: int) -> dict:
    n = pool["img"].shape[0]
    rows = [(i * B + k) % n for k in range(B)]
    return {k: v[rows] for k, v in pool.items()}


def build_state(run, gan, G, D, tcfg):
    """Seeded weights into G and D, then the training state around them."""
    weights.load_seeded(G, run.config["init"], run.seed)
    weights.load_seeded(D, run.config["init"], run.seed + 1)
    return gan.init_gan_state(G, D, tcfg)


def params(state) -> list:
    return [("G." + n, p) for n, p in state.G.named_parameters()] + \
           [("D." + n, p) for n, p in state.D.named_parameters()]


def averages(state) -> list:
    """What the G step's averages update: G_ema's parameters and the mapping's
    w_avg of G and of G_ema."""
    return [("G_ema." + n, p) for n, p in state.G_ema.named_parameters()] + \
           [("G.mapping.w_avg", state.G.mapping.w_avg),
            ("G_ema.mapping.w_avg", state.G_ema.mapping.w_avg)]


def _host(pairs) -> dict:
    return {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in pairs}


def first_steps(state, step_fn, pool, gen, run, half_batch: bool = False) -> dict:
    """The first CHECK_STEPS steps, read for the check: each step's losses,
    the first gradients (Adam's first moment after step 0), the parameters
    before step 0, after it and after the last, and the averages before and
    after step 0."""
    tr = run.traffic
    ps = params(state)
    rec = {"theta0": _host(ps), "avg0": _host(averages(state)), "losses": []}
    for i in range(CHECK_STEPS):
        batch = batch_of(pool, i, tr["batch"])
        if half_batch:
            batch = {k: v[:tr["batch"] // 2] for k, v in batch.items()}
        state, stats = step_fn(state, batch, gen, tr["ada_p"])
        rec["losses"].append({k: float(v) for k, v in stats.items()})
        if i == 0:
            moments = {}
            for opt in (state.opt_g, state.opt_d):
                for group in opt.param_groups:
                    for p in group["params"]:
                        moments[id(p)] = opt.state[p]["exp_avg"]
            rec["grads"] = {n: moments[id(p)].detach().to("cpu", torch.float32, copy=True) for n, p in ps}
            rec["theta1"], rec["avg1"] = _host(ps), _host(averages(state))
    rec["theta3"] = _host(ps)
    return rec


def setup(run):
    from ide3d_tpu_torch.models.discriminator import Discriminator
    from ide3d_tpu_torch.models.generator import Ide3dGenerator
    from ide3d_tpu_torch.parallel.stats import StatsAccumulator
    from ide3d_tpu_torch.train import gan

    gcfg, dcfg, tcfg = train_configs(run)
    with torch.device(run.device):
        G, D = Ide3dGenerator(gcfg), Discriminator(dcfg)
    G, D = G.to(run.device), D.to(run.device)
    shapes = ({k: tuple(v.shape) for k, v in G.state_dict().items()},
              {k: tuple(v.shape) for k, v in D.state_dict().items()})
    state = build_state(run, gan, G, D, tcfg)
    step_fn = gan.make_gan_train_step(tcfg)
    pool = data_pool(run)
    gen = torch.Generator(device=run.device).manual_seed((run.seed + 2) % weights.SEED_MOD)
    rec = first_steps(state, step_fn, pool, gen, run)
    st = types.SimpleNamespace(
        state=state, step_fn=step_fn, pool=pool, gen=gen, rec=rec, shapes=shapes,
        acc=StatsAccumulator(), steps=0, r1_steps=0, step_times=[], r1_times=[],
        trace_units=1, device=run.device, tr=run.traffic)
    common.synchronize(run.device)
    return st


def _one_step(st) -> bool:
    tr = st.tr
    state = st.state
    r1 = state.step % tr["r1_interval"] == 0
    st.state, stats = st.step_fn(state, batch_of(st.pool, state.step, tr["batch"]), st.gen,
                                 tr["ada_p"])
    st.acc.update(stats)
    st.steps += 1
    st.r1_steps += int(r1)
    return r1


def unit(st, i: int) -> None:
    for _ in range(st.tr["r1_interval"]):
        _one_step(st)


def timed(st) -> None:
    """One more R1 cycle, each step's host time ending in a synchronize."""
    for _ in range(st.tr["r1_interval"]):
        t0 = time.perf_counter()
        r1 = _one_step(st)
        common.synchronize(st.device)
        (st.r1_times if r1 else st.step_times).append(1e3 * (time.perf_counter() - t0))


def work(st, win) -> dict:
    """The window's work in FLOPs, from the reference's counted steps (traced runs)."""
    n, n_r1 = win.snapshot["steps"], win.snapshot["r1_steps"]
    f = getattr(st, "flops", None) or {}
    return {"flops": (n - n_r1) * f["plain"] + n_r1 * f["r1"]} if f else {}


def snapshot(st) -> dict:
    return {"steps": st.steps, "r1_steps": st.r1_steps}


def finish(st, run, win) -> dict:
    n = win.snapshot["steps"]
    return {"attempted": st.steps, "failed": 0,
            "e2e": {"train_imgs_per_s": n * run.traffic["batch"] / win.seconds},
            "work": {"k1_batch": run.traffic["batch"]}}


# ------------------------------------------------------------------- check


def reference_record(run, st, quant=None, count_flops: bool = False,
                     half_batch: bool = False) -> dict:
    """The frozen reference's first steps in float32 from the run's weights,
    draws and batches; `quant` rounds every convolution's operands and
    gradients; `half_batch` leaves out half of each batch (a planted fault)."""
    from ..reference.frozen import conv2d_gradfix, discriminator, gan, generator

    gcfg, dcfg, tcfg = train_configs(run, frozen=True, dtype="float32")
    with torch.device(run.device):
        G, D = generator.Ide3dGenerator(gcfg), discriminator.Discriminator(dcfg)
    G, D = G.to(run.device), D.to(run.device)
    state = build_state(run, gan, G, D, tcfg)
    step_fn = gan.make_gan_train_step(tcfg)
    pool = data_pool(run)
    gen = torch.Generator(device=run.device).manual_seed((run.seed + 2) % weights.SEED_MOD)
    conv2d_gradfix.QUANT = quant
    flops = {}
    try:
        with ref.tf32_off():
            if count_flops:
                flops = count_step_flops(state, step_fn, pool, gen, run)
                state = build_state(run, gan, G, D, tcfg)
                gen.manual_seed((run.seed + 2) % weights.SEED_MOD)
            rec = first_steps(state, step_fn, pool, gen, run, half_batch)
    finally:
        conv2d_gradfix.QUANT = None
    rec["flops"] = flops
    del state, G, D
    common.free(run.device)
    return rec


def count_step_flops(state, step_fn, pool, gen, run) -> dict:
    """Convolution and matrix-product FLOPs of an R1 step (step 0) and of a
    plain step (step 1), counted by torch.utils.flop_counter at the cell's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    tr, out = run.traffic, {}
    for i, name in enumerate(("r1", "plain")):
        fc = FlopCounterMode(display=False)
        with fc:
            step_fn(state, batch_of(pool, i, tr["batch"]), gen, tr["ada_p"])
        out[name] = fc.get_total_flops()
    return out


def _norms(d: dict) -> dict:
    return {k: float(v.norm()) for k, v in d.items()}


def _leaf_gaps(got: dict, want: dict, leaves: list) -> dict:
    """Leaf by leaf, the gap of two tensors' norms over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    ng, nw = _norms({k: got[k] for k in leaves}), _norms({k: want[k] for k in leaves})
    med = float(np.median(list(nw.values())))
    return {k: abs(ng[k] - nw[k]) / max(nw[k], med) for k in leaves}


def _unit(grads: dict) -> dict:
    """Each network's gradients over that network's whole norm."""
    out = {}
    for net in ("G.", "D."):
        keys = [k for k in grads if k.startswith(net)]
        total = float(torch.sqrt(sum(grads[k].double().square().sum() for k in keys)))
        out.update({k: grads[k] / max(total, 1e-30) for k in keys})
    return out


def _descent_gaps(got: dict, want: dict, leaves: list) -> dict:
    """Leaf by leaf, step 0's change projected on the reference's first
    gradient, against the reference's own projection: |<g, d_got> - <g, d_want>|
    over |<g, d_want>|. Adam's first step moves each element by about lr times
    the sign of its gradient, so a flipped sign costs in proportion to that
    element's gradient: rounding flips only the small ones, a step in the wrong
    direction or on a stale gradient flips the large ones too."""
    out = {}
    for k in leaves:
        g = want["grads"][k].double()
        d_got = (got["theta1"][k] - got["theta0"][k]).double()
        d_want = (want["theta1"][k] - want["theta0"][k]).double()
        ref = float((g * d_want).sum())
        out[k] = abs(float((g * d_got).sum()) - ref) / max(abs(ref), 1e-30)
    return out


def _change(rec: dict, before: str, after: str, leaves: list) -> dict:
    return {k: rec[after][k] - rec[before][k] for k in leaves}


def gaps(got: dict, want: dict) -> dict:
    """The numbers of a record against the reference's record. Compared (the
    cell's limits): `loss0_gap`, step 0's losses, G's and D's gap over
    max(|reference|, 1) (a saturated logistic loss, e^-14 small, is
    exponentially sensitive to the logits and its relative gap says nothing),
    R1's relative to its own value; `descent0_g_gap` and `descent0_d_gap`, the
    median leaf's gap of step 0's change along the reference's first gradient
    (its direction), of G and of D apart (where D saturates, G's loss is e^-29
    small and its gradient's direction carries the logits' rounding: PERF.md);
    `change_median_gap`, the median leaf's gap of the parameters' change over
    the first steps; `ema_change_gap`, the same of G_ema's change in step 0;
    `w_avg_gap`, the larger gap of the change of G's and G_ema's w_avg in step
    0 (over three steps both follow the later steps, whose losses swing from
    seed to seed: PERF.md). The leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the changes (G_ema's by G's
    gradient). Read by `control.py` only:
    `grad_median_gap`, the median leaf's gap of the first gradients, each
    network's over that network's whole norm, which no control or fault
    separates from sound runs, and the later steps' losses and the worst
    leaves, which swing from seed to seed (PERF.md). A leaf's gap of norms is
    over the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    def rel(a, b, k):
        return abs(a - b) / max(abs(b), 1e-6 if k == "r1_penalty" else 1.0)

    losses = [[rel(a[k], b[k], k) for k in ("loss_g", "loss_d", "r1_penalty")
               if k in b and (k != "r1_penalty" or b[k] != 0.0)]
              for a, b in zip(got["losses"], want["losses"])]
    leaves = list(want["grads"])
    grad = _leaf_gaps(_unit(got["grads"]), _unit(want["grads"]), leaves)
    raw = _leaf_gaps(got["grads"], want["grads"], leaves)
    gw = _norms(want["grads"])
    med = float(np.median(list(gw.values())))
    moved = [k for k in leaves if gw[k] >= 1e-3 * med]
    change = _leaf_gaps(_change(got, "theta0", "theta3", moved),
                        _change(want, "theta0", "theta3", moved), moved)
    descent = _descent_gaps(got, want, moved)
    ema_moved = ["G_ema." + k[2:] for k in moved if k.startswith("G.")]
    ema = _leaf_gaps(_change(got, "avg0", "avg1", ema_moved),
                     _change(want, "avg0", "avg1", ema_moved), ema_moved)
    w_avg = {}
    for k in ("G.mapping.w_avg", "G_ema.mapping.w_avg"):
        ng, nw = (float((r["avg1"][k] - r["avg0"][k]).norm()) for r in (got, want))
        w_avg[k] = abs(ng - nw) / max(nw, 1e-30)
    worst = sorted(raw, key=raw.get)[-2:]
    worst_change = sorted(change, key=change.get)[-2:]
    worst_descent = sorted(descent, key=descent.get)[-2:]
    return {"loss0_gap": max(losses[0]),
            "descent0_g_gap": float(np.median([v for k, v in descent.items() if k.startswith("G.")])),
            "descent0_d_gap": float(np.median([v for k, v in descent.items() if k.startswith("D.")])),
            "change_median_gap": float(np.median(list(change.values()))),
            "ema_change_gap": float(np.median(list(ema.values()))),
            "w_avg_gap": max(w_avg.values()),
            "grad_median_gap": float(np.median(list(grad.values()))),
            "later.loss_gap": max(max(x) for x in losses),
            "later.grad_median_raw_gap": float(np.median(list(raw.values()))),
            "later.grad_worst_gap": raw[worst[-1]],
            "later.change_worst_gap": change[worst_change[-1]],
            "later.descent_worst_gap": descent[worst_descent[-1]],
            "later.grad_worst_leaves": [(k, raw[k], float(got["grads"][k].norm()), gw[k]) for k in worst],
            "later.change_worst_leaves": [(k, change[k], gw[k] / med) for k in worst_change],
            "later.descent_worst_leaves": [(k, descent[k], gw[k] / med) for k in worst_descent],
            "later.losses": [(a, b) for a, b in zip(got["losses"], want["losses"])]}


def check(st, run, win) -> dict:
    rec = st.rec
    del st.state, st.step_fn, st.pool
    common.free(run.device)
    want = reference_record(run, st, count_flops=run.trace)
    st.flops = want["flops"]
    found = gaps(rec, want)
    out = {k: found[k] for k in run.limits}
    if run.control:
        lower = gaps(reference_record(run, st, ref.LOWER[run.config["generator"]["dtype"]]), want)
        half = gaps(reference_record(run, st, half_batch=True), want)
        for name, d in (("program", found), ("lower", lower), ("half_batch", half)):
            out.update({f"control.{name}.{k}": v for k, v in d.items()})
    return out
