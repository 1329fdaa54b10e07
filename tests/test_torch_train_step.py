"""The PyTorch port's GAN train step on the CPU, fp32: its randomness held to
its contracts (R1 cadence, G_ema, w_avg), the D-first variant, the stats
accumulator, the checkpoint round trip and the train_gan CLI with --resume.
The losses and gradients against the JAX package are in
tests/test_torch_train.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from ide3d_tpu import render as jrender
from ide3d_tpu_torch.apps.common import PRESETS
from ide3d_tpu_torch.io.checkpoint import config_from_jsonable, load_checkpoint, save_checkpoint
from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
from ide3d_tpu_torch.models.generator import Ide3dGenerator
from ide3d_tpu_torch.parallel.stats import StatsAccumulator
from ide3d_tpu_torch.train import gan
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

TINY_D = dict(img_resolution=32, img_channels=25, channel_base=512, channel_max=32,
              dtype="float32")
B, R = 4, 32  # B a multiple of the stddev group: the D phase's interleaved call


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported
    (torch.set_grad_enabled(False)), and a test worker imports every module."""
    with torch.enable_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def _tiny_state(tcfg, seed=0):
    G = Ide3dGenerator(PRESETS["tiny"]).init(seed)
    D = Discriminator(DiscriminatorConfig(**TINY_D)).init(seed + 1)
    return gan.init_gan_state(G, D, tcfg)


def _compact_batch(b, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": t(rng.randint(0, 256, (b, R, R, 3), np.uint8)),
            "seg": t(rng.randint(0, 19, (b, R, R), np.uint8)),
            "c": t(np.stack([np.asarray(jrender.CANONICAL_POSE_25)] * b))}


def test_step_moves_params_updates_ema_and_w_avg_with_lazy_r1():
    tcfg = gan.GanTrainConfig(r1_interval=2)
    state = _tiny_state(tcfg)
    g0 = {k: v.clone() for k, v in state.G.state_dict().items()}
    d0 = {k: v.clone() for k, v in state.D.state_dict().items()}
    step = gan.make_gan_train_step(tcfg)
    gen = torch.Generator().manual_seed(1)
    r1 = []
    for _ in range(3):
        state, stats = step(state, _compact_batch(B), gen, 0.3)
        assert all(torch.isfinite(v) for v in stats.values())
        assert set(stats) == {"loss_d", "real_logits", "real_signs", "r1_penalty", "loss_g", "fake_logits"}
        r1.append(float(stats["r1_penalty"]))
    assert state.step == 3
    assert r1[0] > 0 and r1[1] == 0 and r1[2] > 0  # every r1_interval steps
    key = "synthesis.vb4.conv.weight"
    moved = float((state.G.state_dict()[key] - g0[key]).abs().max())
    ema = float((state.G_ema.state_dict()[key] - g0[key]).abs().max())
    assert moved > 0 and 0 < ema < moved
    assert float((state.D.state_dict()["b4.out.weight"] - d0["b4.out.weight"]).abs().max()) > 0
    w_avg = state.G.mapping.w_avg
    assert 0 < float((w_avg - g0["mapping.w_avg"]).abs().max()) < 1.0
    assert torch.equal(state.G_ema.mapping.w_avg, w_avg * 0 + state.G_ema.mapping.w_avg)
    assert float((state.G_ema.mapping.w_avg - w_avg).abs().max()) > 0
    assert all(p.grad is None for p in state.G.parameters())  # nothing left for the next step


def test_step_d_first_without_fake_reuse():
    """fake_reuse=False: the D phase draws its own fakes; B=2 takes the two-call D."""
    tcfg = gan.GanTrainConfig(r1_interval=1, fake_reuse=False, use_ada=False)
    state = _tiny_state(tcfg, seed=2)
    state, stats = gan.make_gan_train_step(tcfg)(state, _compact_batch(2, seed=1),
                                                 torch.Generator().manual_seed(0))
    assert state.step == 1 and all(torch.isfinite(v) for v in stats.values())


def test_stats_accumulator():
    acc = StatsAccumulator()
    for v in (1.0, 2.0, 6.0):
        acc.update({"a": torch.tensor(v), "b": -v})
    assert acc.mean("a") == pytest.approx(3.0)
    assert acc.std("a") == pytest.approx(np.std([1.0, 2.0, 6.0]))
    assert acc.mean("b") == pytest.approx(-3.0)
    acc.update({"c": torch.tensor(5.0)})  # a stat that appears later
    assert acc.as_dict()["c"] == 5.0
    acc.reset()
    assert acc.as_dict() == {}


def test_checkpoint_round_trip(tmp_path):
    tcfg = gan.GanTrainConfig()
    state = _tiny_state(tcfg, seed=3)
    step = gan.make_gan_train_step(tcfg)
    state, _ = step(state, _compact_batch(B), torch.Generator().manual_seed(0), 0.5)
    saved = {"G": state.G.state_dict(), "D": state.D.state_dict(), "G_ema": state.G_ema.state_dict(),
             "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
             "pl_mean": state.pl_mean}
    save_checkpoint(str(tmp_path / "snap"), saved, config=state.G.cfg, step=state.step, ada_p=0.25)
    loaded, meta = load_checkpoint(str(tmp_path / "snap"))
    assert meta["step"] == 1 and meta["ada_p"] == 0.25
    assert config_from_jsonable(meta["config"]) == state.G.cfg
    fresh = _tiny_state(tcfg, seed=9)
    for name in ("G", "D", "G_ema", "opt_g", "opt_d"):
        getattr(fresh, name).load_state_dict(loaded[name])
    for name in ("G", "D", "G_ema"):
        a, b = getattr(fresh, name).state_dict(), saved[name]
        assert all(torch.equal(a[k], b[k]) for k in b)
    st = fresh.opt_g.state_dict()["state"]
    assert all(torch.equal(st[i]["exp_avg_sq"], saved["opt_g"]["state"][i]["exp_avg_sq"]) for i in st)


def _write_dataset(root, n=4):
    import PIL.Image

    imgs, segs = root / "imgs", root / "segs"
    imgs.mkdir()
    segs.mkdir()
    rng = np.random.RandomState(0)
    labels = {}
    for i in range(n):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(imgs / name)
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(segs / name)
        labels[name] = np.asarray(jrender.CANONICAL_POSE_25, float).tolist()
    with open(imgs / "dataset.json", "w") as f:
        json.dump({"labels": list(labels.items())}, f)
    return ["--data", str(imgs), "--seg", str(segs)]


def test_train_gan_cli_runs_snapshots_and_resumes(tmp_path):
    """The CLI on the CPU (tiny preset): two steps, a sample grid, the final
    snapshot, --metrics fid (pixel detector) at its kimg and the stats row of
    the steps that end mid-interval; --resume of it restores every state dict,
    the step and ada_p."""
    from ide3d_tpu_torch.apps.train_gan import main

    common = _write_dataset(tmp_path) + [
        "--batch", "2", "--kimg", "0.004", "--resolution", str(R), "--preset", "tiny",
        "--grid-kimg", "1", "--snap-kimg", "1", "--fixed-ada-p", "0.3", "--device", "cpu"]
    first = main(common + ["--outdir", str(tmp_path / "run"), "--metrics", "fid",
                           "--metric-items", "4", "--metric-detector", "pixel"])
    files = os.listdir(tmp_path / "run")
    assert "snapshot-final" in files and "fakes000000.png" in files and "fakes000000_seg.png" in files
    assert first.step == 2
    (line,) = [json.loads(s) for s in (tmp_path / "run" / "metric-fid.jsonl").read_text().splitlines()]
    assert line["kimg"] == 0.004 and line["num_items"] == 4 and np.isfinite(line["results"]["fid"])
    assert ".metric_cache" in files
    (row,) = [json.loads(s) for s in (tmp_path / "run" / "stats.jsonl").read_text().splitlines()]
    assert row["kimg"] == 0.004 and row["ada_p"] == 0.3  # the 2 steps end mid-interval
    assert all(np.isfinite(v) for v in row.values())
    resumed = main(common + ["--outdir", str(tmp_path / "resumed"),
                             "--resume", str(tmp_path / "run" / "snapshot-final")])
    assert resumed.step == 2
    for name in ("G", "D", "G_ema"):
        a, b = getattr(first, name).state_dict(), getattr(resumed, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    sa, sb = first.opt_d.state_dict()["state"], resumed.opt_d.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg"], sb[i]["exp_avg"]) for i in sa)
    meta = json.loads((tmp_path / "resumed" / "snapshot-final" / "meta.json").read_text())
    assert meta["step"] == 2 and meta["ada_p"] == 0.3


def test_training_modules_leave_jax_out():
    """The training modules, the samplers and K1 (with its double backward),
    the metric suite that train_gan --metrics runs, and the port's synthetic
    dataset tool import neither jax nor the JAX package."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, 'tools'); import torch_make_synthetic_dataset, "
            "ide3d_tpu_torch.apps.train_gan, ide3d_tpu_torch.train.gan, "
            "ide3d_tpu_torch.train.augment, ide3d_tpu_torch.ops.grid_sample, "
            "ide3d_tpu_torch.ops.ray_march, ide3d_tpu_torch.ops.upfirdn2d, "
            "ide3d_tpu_torch.data.dataset, ide3d_tpu_torch.io.checkpoint, "
            "ide3d_tpu_torch.parallel.stats, ide3d_tpu_torch.metrics.metric_main, "
            "ide3d_tpu_torch.metrics.lpips, ide3d_tpu_torch.metrics.perceptual_path_length, "
            "ide3d_tpu_torch.metrics.equivariance, ide3d_tpu_torch.metrics.frechet_inception_distance, "
            "ide3d_tpu_torch.metrics.kernel_inception_distance, ide3d_tpu_torch.metrics.precision_recall, "
            "ide3d_tpu_torch.metrics.inception_score, ide3d_tpu_torch.apps.calc_metrics; "
            "print('jax' in sys.modules, 'ide3d_tpu' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.split() == ["False", "False"]
