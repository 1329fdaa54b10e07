"""The port's three trained-weight tools against the JAX package's, on the CPU:
tools/torch_import_and_verify.py, torch_eval_trained_encoder.py and
torch_painter_trained_demo.py beside tools/import_and_verify.py,
eval_trained_encoder.py and painter_trained_demo.py.

import_and_verify: both tools import the fixture pickle of
tests/test_import_verify.py at --dtype float32; the goldens agree (ws within
1e-5, img and seg within 1e-4, times the reference's scale max(1, max|ref|)),
the port's --check-golden passes against the JAX tool's file, and the exit
codes agree (2 on the ambiguous decoder, 3 on a pickle without a generator).
The eval and demo tools run on a few views of
tools/torch_make_synthetic_dataset.py at 32², with the tiny G and a
HybridEncoder initialised by JAX and bridged through io/from_jax (each tool's
loaders patched to hand over the bridged networks): the eval JSON agrees
within 1e-5 times max(1, |ref|) before the tools' rounding (seg mIoU within
1e-3: argmax ties), the demo's PNGs within 1 uint8 level.
"""

import ast
import importlib
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import test_import_verify as tiv
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models.encoder import HybridEncoder as JHybridEncoder
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.models.encoder import HybridEncoder
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.render.renderer import RenderParams
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import eval_trained_encoder  # noqa: E402
import import_and_verify  # noqa: E402
import painter_trained_demo  # noqa: E402
import torch_eval_trained_encoder  # noqa: E402
import torch_import_and_verify  # noqa: E402
import torch_make_synthetic_dataset  # noqa: E402
import torch_painter_trained_demo  # noqa: E402

TOOLS = ("torch_import_and_verify", "torch_eval_trained_encoder", "torch_painter_trained_demo")
TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            w_dim=64, dtype="float32")  # w_dim 64: the encoder's projectors scale with it
IV_ARGS = ["--render-size", "8", "--num-steps", "4", "--dtype", "float32"]


def _scaled_close(name, got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol * scale, (name, float(np.abs(got - ref).max()))


# ------------------------------------------------------------ import_and_verify


def test_import_and_verify_goldens_match_jax(tmp_path):
    g = tiv._fixture_g(renderer="decoder")
    torch.manual_seed(3)
    tiny_d = tiv.tip.TinyD()
    tiv.tip._randomize(tiny_d, 5)
    pkl = str(tmp_path / "net.pkl")
    tiv._make_pkl(pkl, {"G_ema": g, "D": tiny_d}, module_name="fake_torch_tools_networks")
    jout, tout = tmp_path / "jax", tmp_path / "port"
    assert import_and_verify.main([pkl, "--outdir", str(jout), *IV_ARGS]) == 0
    assert torch_import_and_verify.main([pkl, "--outdir", str(tout), *IV_ARGS,
                                         "--device", "cpu"]) == 0
    ref, got = np.load(jout / "golden_import.npz"), np.load(tout / "golden_import.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        _scaled_close(k, got[k], ref[k], 1e-5 if k.startswith("ws") else 1e-4)
    assert (tout / "ckpt" / "meta.json").exists()
    for seed in range(4):
        assert (tout / "images" / f"seed{seed:04d}.png").exists()
    # The port's --check-golden holds its import to the JAX tool's goldens.
    assert torch_import_and_verify.main([pkl, "--outdir", str(tmp_path / "again"), *IV_ARGS,
                                         "--device", "cpu", "--check-golden",
                                         str(jout / "golden_import.npz")]) == 0


@pytest.mark.parametrize("case", ["ambiguous", "no_generator"])
def test_import_and_verify_exit_codes_match_jax(tmp_path, case):
    if case == "ambiguous":
        entries, want = {"G_ema": tiv._fixture_g(renderer="ambiguous")}, 2
    else:
        torch.manual_seed(3)
        tiny_d = tiv.tip.TinyD()
        tiv.tip._randomize(tiny_d, 5)
        entries, want = {"D": tiny_d}, 3
    pkl = str(tmp_path / "net.pkl")
    tiv._make_pkl(pkl, entries, module_name=f"fake_torch_tools_{case}")
    assert import_and_verify.main([pkl, "--outdir", str(tmp_path / "j"), *IV_ARGS]) == want
    assert torch_import_and_verify.main([pkl, "--outdir", str(tmp_path / "t"), *IV_ARGS,
                                         "--device", "cpu"]) == want
    assert not (tmp_path / "t" / "ckpt").exists()


# ------------------------------------------------------------- eval and demo


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The tiny JAX G (w_dim 64) and a HybridEncoder at its width, their port
    copies, and 3 identities x 4 views of the synthetic dataset at 32²."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    g_params = jax.jit(jG.init)(jax.random.PRNGKey(0))
    n_geo = jG.synthesis.num_ws_geo
    jE = JHybridEncoder(size=32, n_latents_app=jG.num_ws - n_geo, n_latents_geo=n_geo, w_dim=64)
    e_params = jax.jit(jE.init)(jax.random.PRNGKey(1))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, jax.tree_util.tree_map(np.asarray, g_params))
    E = HybridEncoder(size=32, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo, w_dim=64)
    load_jax_params(E, jax.tree_util.tree_map(np.asarray, e_params))
    data = str(tmp_path_factory.mktemp("sphere"))
    torch_make_synthetic_dataset.main(["--out", data, "--identities", "3", "--views", "4",
                                       "--resolution", "32"])
    return {"jG": jG, "g_params": g_params, "e_params": e_params, "G": G.eval(),
            "E": E.eval().requires_grad_(False), "data": data}


def _patch_loaders(monkeypatch, bridged):
    """Both packages' loaders hand over the bridged networks (no snapshot files)."""
    import ide3d_tpu.apps.common as jcommon
    import ide3d_tpu.io.checkpoint as jckpt
    from ide3d_tpu_torch.apps import common, infer_hybrid_encoder

    monkeypatch.setattr(jcommon, "load_generator", lambda path: (bridged["jG"], bridged["g_params"]))
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda path: ({"E": bridged["e_params"]}, {}))
    monkeypatch.setattr(common, "load_generator", lambda path, device: bridged["G"])
    monkeypatch.setattr(infer_hybrid_encoder, "build_encoder", lambda G, path, device: bridged["E"])


def test_eval_trained_encoder_matches_jax(bridged, monkeypatch, capsys):
    _patch_loaders(monkeypatch, bridged)
    # The JSON's rounding (5 and 4 digits) is taken out on both sides.
    for mod in (eval_trained_encoder, torch_eval_trained_encoder):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x, raising=False)
    argv = ["--network", "g", "--encoder", "e", "--data", bridged["data"], "--n", "10",
            "--batch", "4"]
    eval_trained_encoder.main(argv)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    torch_eval_trained_encoder.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n"] == ref["n"] == 8  # the ragged tail of 2 is dropped
    for k in ("rgb_l2", "ws_spread"):
        _scaled_close(k, got[k], ref[k], 1e-5)
    assert abs(got["seg_miou"] - ref["seg_miou"]) <= 1e-3


def test_painter_trained_demo_matches_jax(bridged, monkeypatch, tmp_path):
    import PIL.Image

    _patch_loaders(monkeypatch, bridged)
    argv = ["--network", "g", "--encoder", "e", "--data", bridged["data"], "--item", "00001_2"]
    painter_trained_demo.main(argv + ["--outdir", str(tmp_path / "j")])
    torch_painter_trained_demo.main(argv + ["--outdir", str(tmp_path / "t"), "--device", "cpu"])
    for name in ("painter_trained_recon", "painter_trained_edit", "painter_trained_edit_mask"):
        ref = np.asarray(PIL.Image.open(tmp_path / "j" / f"{name}.png"), np.int32)
        got = np.asarray(PIL.Image.open(tmp_path / "t" / f"{name}.png"), np.int32)
        assert got.shape == ref.shape, name
        assert np.abs(got - ref).max() <= 1, (name, np.abs(got - ref).max())


def test_painter_demo_hair_dilation_matches_jax(bridged):
    """The demo's mask edit grows the hair class downward over skin only."""
    import PIL.Image

    mask = np.asarray(PIL.Image.open(os.path.join(bridged["data"], "seg", "00001_2.png")), np.int64)
    edited = torch_painter_trained_demo.dilate_hair(mask, 5)
    assert (edited != mask).any() and ((edited != mask) <= (mask == 1)).all()
    assert (edited[edited != mask] == 17).all()


# ---------------------------------------------------------------- the contract


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_default_to_cuda(tool, monkeypatch):
    """`--device` defaults to cuda with no CPU fallback: the first load is asked
    for the card unless --device cpu is given."""
    from ide3d_tpu_torch.apps import common
    from ide3d_tpu_torch.io import torch_import

    class _Stop(Exception):
        pass

    seen = []

    def stop(*args, device="?", **kw):
        seen.append(torch.device(device if device != "?" else args[-1]))
        raise _Stop

    monkeypatch.setattr(common, "load_generator", stop)
    monkeypatch.setattr(torch_import, "load_network_pkl", stop)
    mod = sys.modules[tool]
    argv = (["x.pkl"] if tool == "torch_import_and_verify"
            else ["--network", "g", "--encoder", "e", "--data", "d", "--outdir", "o"][
                : 6 if tool == "torch_eval_trained_encoder" else 8])
    for extra, want in (([], "cuda"), (["--device", "cpu"], "cpu")):
        with pytest.raises(_Stop):
            mod.main(argv + extra)
        assert seen.pop() == torch.device(want)


def test_tools_import_no_jax():
    """The three tools (and the workflow script and its dtype leg) import
    nothing of jax or ide3d_tpu, at the top or inside a function. What they import is imported
    without either by tests/test_torch_preprocess.py::test_new_modules_import_no_jax."""
    from test_torch_preprocess import TOOL_IMPORTS

    imported = set()
    for name in TOOLS + ("torch_trained_workflow", "torch_train_gan_dtype"):
        tree = ast.parse(open(os.path.join(REPO, "tools", name + ".py")).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                imported |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                for a in node.names:  # "from package import module" names the module
                    sub = f"{node.module}.{a.name}"
                    is_module = (node.module.startswith("ide3d_tpu_torch")
                                 and hasattr(importlib.import_module(node.module), "__path__")
                                 and importlib.util.find_spec(sub) is not None)
                    imported.add(sub if is_module else node.module)
    roots = {m.split(".")[0] for m in imported}
    assert "jax" not in roots and "ide3d_tpu" not in roots, sorted(imported)
    port = {m for m in imported if m.startswith("ide3d_tpu_torch")}
    assert port <= set(TOOL_IMPORTS), sorted(port - set(TOOL_IMPORTS))
    assert set(TOOLS) < set(TOOL_IMPORTS)


# ------------------------------------------------------- the flagship run B mode


def _flags(argv):
    assert argv[:2] == ["-m", "ide3d_tpu_torch.apps.train_gan"] and len(argv) % 2 == 0
    return dict(zip(argv[2::2], argv[3::2]))


def test_flagship_train_gan_argv_is_run_b(monkeypatch):
    """The flagship mode's two legs pass TRAINING.md run B's flags plus
    --device, and no --r1-gamma or --pl-weight: train_gan's own parser reads
    them as γ auto (None) and PL off."""
    import torch_trained_workflow as wf
    from ide3d_tpu_torch.apps import train_gan
    from ide3d_tpu_torch.parallel import mesh

    run_b = {"--data": os.path.join("d", "img"), "--seg": os.path.join("d", "seg"),
             "--outdir": "r", "--preset": "full", "--resolution": "512", "--batch": "4",
             "--snap-kimg": "4", "--grid-kimg": "2", "--metrics": "fid", "--metric-items": "500",
             "--ada-speed": "100", "--device": "cuda"}
    leg1 = wf.flagship_gan_argv("d", "r", 12, "cuda")
    leg2 = wf.flagship_gan_argv("d", "r", 20, "cuda", resume="r/snapshot-final")
    assert _flags(leg1) == {**run_b, "--kimg": "12"}
    assert _flags(leg2) == {**run_b, "--kimg": "20", "--resume": "r/snapshot-final"}
    monkeypatch.setattr(mesh, "dp_world", lambda batch, device_type: 1)
    monkeypatch.setattr(mesh, "launch", lambda fn, world, device_type, args: args)
    for argv, kimg in ((leg1, 12), (leg2, 20)):
        args = train_gan.main(argv[2:])
        assert (args.r1_gamma, args.pl_weight, args.kimg, args.batch) == (None, 0.0, kimg, 4)


def test_flagship_resume_check():
    """Leg 2 must append to leg 1's stats and FID lines and resume at leg 1's
    last ada_p within one controller update (4 steps x batch 4 / speed 100k)."""
    import torch_trained_workflow as wf

    leg1 = [{"kimg": 0.4, "ada_p": 0.004}, {"kimg": 0.8, "ada_p": 0.008}]
    leg2 = [{"kimg": 1.2, "ada_p": 0.012}]
    fid1, fid2 = [{"kimg": 0.8}], [{"kimg": 1.2}]
    log = "r1-gamma (auto): 13.1\nresumed /x/snapshot-final: step 200, ada_p 0.00815\n"
    rec = wf.resume_check(leg1, leg1 + leg2, fid1, fid1 + fid2, log)
    assert rec["rows"] == [2, 1] and rec["resumed_step"] == 200 and rec["one_update"] == 1.6e-4
    assert rec["fid_kimg"] == [0.8, 1.2] and rec["leg2_first"] == leg2[0]
    for bad in ((leg1, leg2, fid1, fid1 + fid2, log),  # leg 1's rows rewritten
                (leg1, leg1 + leg2, fid1, fid1, log),  # no FID line added
                (leg1, leg1 + leg2, fid1, fid1 + fid2, log.replace("0.00815", "0.0082"))):
        with pytest.raises(SystemExit):
            wf.resume_check(*bad)


def test_compare_flagship_tables(tmp_path, monkeypatch, capsys):
    """compare_sphere_runs --run flagship on the JAX run-B record and a made-up
    port record: every FID and stats row, each run's largest |logit|, and the
    grid std of a synthetic 4x4 grid PNG (its uint8 std, per-channel std and
    tile spread)."""
    import PIL.Image

    import compare_sphere_runs as cmp

    docs = tmp_path / "docs"
    (docs / "img").mkdir(parents=True)
    for name in ("flagship_runB_stats.jsonl", "flagship_runB_metric_fid.jsonl",
                 "img/flagship_runB_fakes_16kimg.png"):
        (docs / name).symlink_to(os.path.join(REPO, "docs", name))
    kimgs = (0.4, 4.0, 8.0, 12.0, 16.0, 20.0)
    with open(docs / "torch_flagship_runB_stats.jsonl", "w") as f:
        for k in kimgs:
            f.write(json.dumps({"kimg": k, "time_h": k / 60, "ada_p": k / 100, "real_logits": 5 + k,
                                "fake_logits": -5 - k, "loss_d": 0.5, "loss_g": 1.0,
                                "real_signs": 0.9}) + "\n")
    with open(docs / "torch_flagship_runB_metric_fid.jsonl", "w") as f:
        for k in kimgs[1:]:
            f.write(json.dumps({"kimg": k, "results": {"fid": 100 + k}}) + "\n")
    grid = np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    PIL.Image.fromarray(grid).save(docs / "img" / "torch_flagship_runB_fakes_4kimg.png")
    monkeypatch.setattr(cmp, "DOCS", str(docs))
    cmp.main(["--run", "flagship"])
    out = capsys.readouterr().out
    jax_fid = {4: "99.39", 8: "405.9", 12: "105.5", 16: "87.93", 20: "94.05"}
    for k, j in jax_fid.items():
        assert f"| {k} | {j} | {cmp.fmt(100.0 + k, 4)} |" in out
    jax_rows = {0.4: "| 0.4 | 8.47 | 5.4 | -8.56 | -5.4 | 0.0488 | 0.5 | 1 | 0.9 | 0.004 | 0.004 |",
                20: "| 20 | 10.4 | 25 | -12.9 | -25 | 4.6e-05 | 0.5 | 1 | 0.9 | 0.198 | 0.2 |"}
    for line in jax_rows.values():
        assert line in out
    assert sum(ln.startswith(f"| {k:g} | ") and ln.count("|") == 12
               for k in kimgs for ln in out.splitlines()) == len(kimgs)
    assert "| JAX | 69.5 | 16 | 32.6 | -69.5 |" in out and "| port | 25 | 20 | 25 | -25 |" in out
    tiles = grid.astype(np.float64).reshape(4, 16, 4, 16, 3).transpose(0, 2, 1, 3, 4)
    spread = tiles.reshape(16, 16, 16, 3).std(0).mean()
    chan = np.mean([grid[..., c].std() for c in range(3)])
    assert (f"| 4 | 19.8 | — | — | — | {cmp.fmt(grid.std())} | {cmp.fmt(chan)} | "
            f"{cmp.fmt(spread)} |") in out
    assert "| 16 | — | 16.8 | 1.34 | 0.617 | — | — | — |" in out and "| 18 | 13.4 |" in out


def test_grid_std_reads_a_flat_colour_grid_as_collapsed(tmp_path):
    """TRAINING.md's grid std (all uint8 values) reads a grid of one flat
    colour as the spread of that colour's R, G and B (~22 here): it cannot see
    a mean-colour collapse. The per-channel std reads it as 0, and reads a
    grid with structure in every tile as high."""
    import PIL.Image

    import compare_sphere_runs as cmp

    flat = np.broadcast_to(np.array([139, 128, 86], np.uint8), (64, 64, 3))
    PIL.Image.fromarray(np.ascontiguousarray(flat)).save(tmp_path / "flat.png")
    ramp = np.broadcast_to(np.linspace(0, 255, 16).astype(np.uint8)[None, :, None], (16, 16, 3))
    PIL.Image.fromarray(np.ascontiguousarray(np.tile(ramp, (4, 4, 1)))).save(tmp_path / "ramp.png")
    grid, chan, spread = cmp.grid_std(str(tmp_path / "flat.png"))
    assert grid > 20 and chan == 0 and spread == 0
    grid, chan, spread = cmp.grid_std(str(tmp_path / "ramp.png"))
    assert chan > 70 and spread == 0


def test_k1_check_limits_follow_dtype():
    """The K1 stage holds bf16 values to PERF.md §2's bf16 limits (forward 1e-3,
    backward 1e-2 x max|grad|), fp32 to 1e-4 and 1e-4, and names what it applied."""
    import torch_trained_workflow as wf

    rec = {"fwd_max_abs_err": 5e-4, "bwd_err_of_max_grad": 5e-3, "finite": True}
    assert wf.k1_verdict({**rec, "dtype": "torch.bfloat16"})["fwd_max_abs_err"] == 5e-4
    with pytest.raises(SystemExit, match=r"at torch.float32: forward 0.0001, backward 0.0001 x"):
        wf.k1_verdict({**rec, "dtype": "torch.float32"})
    with pytest.raises(SystemExit, match=r"at torch.bfloat16: forward 0.001, backward 0.01 x"):
        wf.k1_verdict({**rec, "dtype": "torch.bfloat16", "bwd_err_of_max_grad": 2e-2})
    with pytest.raises(SystemExit):
        wf.k1_verdict({**rec, "dtype": "torch.bfloat16", "finite": False})
    assert wf.k1_verdict({**rec, "fwd_max_abs_err": 9e-5, "bwd_err_of_max_grad": 9e-5,
                          "dtype": "torch.float32"})


def test_dtype_leg_forces_every_compute_dtype():
    """tools/torch_train_gan_dtype.py's patch reaches G, D and ADA however
    their configs are made (a preset's copy, D's config with its own dtype),
    reports what they compute in, reports no D where none was built, and
    leaves the classes as they were."""
    import dataclasses

    import torch_train_gan_dtype as tool
    from ide3d_tpu_torch.apps.common import PRESETS
    from ide3d_tpu_torch.models.discriminator import Discriminator, DiscriminatorConfig
    from ide3d_tpu_torch.train.augment import AugmentConfig

    with tool.forced_dtype("bfloat16") as built:
        Ide3dGenerator(dataclasses.replace(PRESETS["tiny"], img_resolution=32))
        AugmentConfig()
        assert tool.compute_dtypes(built) == {"G": ["bfloat16"], "D": [], "ada": ["bfloat16"]}
        Discriminator(DiscriminatorConfig(img_resolution=32, img_channels=25, channel_base=512,
                                          channel_max=32, dtype="float32"))
    assert tool.compute_dtypes(built) == {"G": ["bfloat16"], "D": ["bfloat16"], "ada": ["bfloat16"]}
    assert dataclasses.replace(PRESETS["tiny"]).dtype == "float32"
    assert AugmentConfig().compute_dtype == "bfloat16" and DiscriminatorConfig().dtype == "bfloat16"
    assert len(built["G"]) == len(built["D"]) == len(built["ada"]) == 1
