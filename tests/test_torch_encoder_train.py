"""The port's hybrid-encoder training (train/encoder.py and the
train_hybrid_encoder, finetune_hybrid_encoder and calc_losses_on_images CLIs)
against the JAX package, on the CPU.

The tiny preset (32² out), its G and HybridEncoder(32, 8, 4) drawn by the JAX
inits and bridged through io/from_jax.py, fp32, one intra-op thread, G with
non-zero layer-noise strengths and renders of an image's scale (_test_g). One train step with BiSeNet and small
perceptual, LPIPS and identity callbacks written alike in both packages (the
pyramid features, a per-sample pyramid distance, a fixed projection of the
8²-resized image): its stats and E's gradients at the JAX step's own z (from
its key), the JAX gradients read from Adam's first moment after the step
(mu = (1 - beta1) g). The CLIs: train_hybrid_encoder with every loss network
from files and --resume (files, stats, the restored state); finetune's step-0
loss on the bridged G and E against the JAX CLI's loss function written from
the JAX package's pieces (forward only: E's gradient through that graph is
held to JAX's by the step test); calc_losses against the JAX CLI on the same
weights and images (l2, lpips, miou) and its id against the cosine of the
port's ArcFace embeddings (embed_faces is held to JAX's in
tests/test_torch_face_nets.py).
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import PIL.Image
import pytest
import torch
import torch.nn.functional as F

from ide3d_tpu import render as jrender
from ide3d_tpu.apps import calc_losses_on_images as jcalc
from ide3d_tpu.apps import infer_hybrid_encoder as jinfer
from ide3d_tpu.models import GeneratorConfig as JGeneratorConfig
from ide3d_tpu.models import Ide3dGenerator as JGenerator
from ide3d_tpu.models.bisenet import BiSeNet as JBiSeNet
from ide3d_tpu.models.encoder import HybridEncoder as JHybridEncoder
from ide3d_tpu.render.renderer import RenderParams as JRenderParams
from ide3d_tpu.train import encoder as jenc
from ide3d_tpu.train import losses as jL
from ide3d_tpu.train import pti as jpti
from ide3d_tpu.utils.seg import mask2onehot as jmask2onehot
from ide3d_tpu_torch.apps import calc_losses_on_images, finetune_hybrid_encoder, train_hybrid_encoder
from ide3d_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from ide3d_tpu_torch.io.from_jax import load_jax_params
from ide3d_tpu_torch.metrics.features import VGG16Features, load_state_dict_file, resize
from ide3d_tpu_torch.metrics.lpips import LPIPS
from ide3d_tpu_torch.models.arcface import ArcFaceIRSE50
from ide3d_tpu_torch.models.bisenet import BiSeNet
from ide3d_tpu_torch.models.encoder import HybridEncoder
from ide3d_tpu_torch.models.generator import GeneratorConfig, Ide3dGenerator
from ide3d_tpu_torch.render.renderer import RenderParams
from ide3d_tpu_torch.train import encoder as tenc
from ide3d_tpu_torch.train import pti
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)
from torch_tmp import drop_tmp_path  # noqa: F401 (an autouse fixture)

TINY = dict(img_resolution=32, render_size=8, plane_resolution=16, channel_base=512,
            channel_max=32, sr_channel_base=256, sr_channel_max=16, feature_channels=8,
            dtype="float32")
R, B = 32, 2
TOL = 1e-4  # x max: fp32 losses and gradients through G, E and BiSeNet


@pytest.fixture(autouse=True)
def _autograd_on():
    """Some test modules turn autograd off when they are imported, and a test
    worker imports every module."""
    with torch.enable_grad():
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel_close(got, ref, tol=TOL, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (name, err, scale)


def _test_g(path, x):
    """Noise strengths 0.3; the RGB heads' weights (raw_rgb, each superres
    torgb) at 1/100: the init's renders reach ±130, where BiSeNet's logits reach
    ±500 and its softmax saturates, so that its cross-entropy gradient in fp32
    is off its fp64 value by 5e-5 (port) and 1.2e-5 (JAX) of its scale; renders
    within a few units, as images are, keep both at ~1e-6."""
    keys = [p.key for p in path]
    if keys[-1] == "noise_strength":
        return jnp.full_like(x, 0.3)
    if keys[0] == "synthesis" and (keys[1:] == ["raw_rgb", "weight"]
                                   or (keys[1].startswith("b") and keys[2:] == ["torgb", "weight"])):
        return x * 0.01
    return x


@pytest.fixture(scope="module")
def nets():
    """JAX and port G (_test_g), E and BiSeNet on the same weights."""
    jG = JGenerator(JGeneratorConfig(**TINY, render=JRenderParams(img_size=8, num_steps=4)))
    gp = jax.tree_util.tree_map_with_path(_test_g, jax.jit(jG.init)(jax.random.PRNGKey(0)))
    G = Ide3dGenerator(GeneratorConfig(**TINY, render=RenderParams(img_size=8, num_steps=4)))
    load_jax_params(G, _np(gp))
    n_geo = jG.synthesis.num_ws_geo
    jE = JHybridEncoder(size=R, n_latents_app=jG.num_ws - n_geo, n_latents_geo=n_geo)
    ep = jax.jit(jE.init)(jax.random.PRNGKey(1))
    E = HybridEncoder(size=R, n_latents_app=G.num_ws - n_geo, n_latents_geo=n_geo)
    load_jax_params(E, _np(ep))
    bp = JBiSeNet(20).init(None)
    return jG, gp, G.eval().requires_grad_(False), jE, ep, E, bp, BiSeNet(20).init().eval()


def _callbacks(m):
    """(vgg_feats, lpips_fn, id_embed) written alike for JAX (jnp) and the port (torch)."""
    def jlp(x, y):
        return sum(jnp.mean(jnp.square(a - b), axis=(1, 2, 3))
                   for a, b in zip(jpti.default_pyramid_feats(x), jpti.default_pyramid_feats(y)))

    def tlp(x, y):
        return sum((a - b).square().mean(dim=(1, 2, 3))
                   for a, b in zip(pti.default_pyramid_feats(x), pti.default_pyramid_feats(y)))

    jid = lambda x: jax.image.resize(x, (x.shape[0], 8, 8, 3), "bilinear").reshape(x.shape[0], -1) @ m
    tid = lambda x: resize(x, 8).reshape(x.shape[0], -1) @ torch.from_numpy(m)
    return (jpti.default_pyramid_feats, jlp, jid), (pti.default_pyramid_feats, tlp, tid)


def test_encoder_step_matches_jax(nets):
    jG, gp, G, jE, ep, E, bp, bis = nets
    rng = np.random.RandomState(4)
    cams = [np.asarray(jrender.make_label_25(jrender.look_at_pose(
        np.pi / 2 + 0.2 * i, np.pi / 2, [0.0, 0.0, 0.0], radius=2.7)))[0] for i in range(B)]
    batch = {"img": rng.uniform(-1, 1, (B, R, R, 3)).astype(np.float32),
             "seg": (np.eye(19, dtype=np.float32)[rng.randint(0, 19, (B, R, R))] * 2 - 1),
             "c": np.stack(cams).astype(np.float32)}
    (jv, jlp, jid), (tv, tlp, tid) = _callbacks(rng.randn(8 * 8 * 3, 16).astype(np.float32))
    tcfg = jenc.EncoderTrainConfig()
    step = jenc.make_encoder_train_step(jE, jG, tcfg, bisenet=JBiSeNet(20), vgg_feats=jv,
                                        lpips_fn=jlp, id_embed=jid)
    key = jax.random.PRNGKey(2)
    ep = jax.tree_util.tree_map(jnp.array, ep)  # a copy: the step donates its state
    state = jenc.EncoderTrainState(jnp.zeros((), jnp.int32), ep,
                                   optax.adam(tcfg.lr, b1=tcfg.beta1, b2=tcfg.beta2).init(ep))
    new_state, ref_stats = step(state, gp, bp, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    z = jax.random.normal(jax.random.split(key)[0], (B, 512))
    ref_grads = jax.tree_util.tree_map(lambda m: m / (1.0 - tcfg.beta1), new_state.opt_e[0].mu)

    total, stats = tenc.encoder_loss(E, G, tenc.EncoderTrainConfig(),
                                     {k: torch.from_numpy(v) for k, v in batch.items()},
                                     torch.from_numpy(np.array(z)), bis, tv, tlp, tid)
    assert set(stats) == set(ref_stats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(ref_stats[k]), rtol=TOL, err_msg=k)
    grads = torch.autograd.grad(total, list(E.parameters()))
    probe = load_jax_params(HybridEncoder(size=R, n_latents_app=E.n_latents_app,
                                          n_latents_geo=E.n_latents_geo), _np(ref_grads))
    got = np.concatenate([g.numpy().ravel() for g in grads])
    ref = np.concatenate([p.detach().numpy().ravel() for p in probe.parameters()])
    # The JAX package's own fp32 error sets this limit: its E gradient differs
    # from the port's E in fp64 by 3.4e-4 of the max (in conv biases, sums of
    # 2048 terms that cancel), the port's fp32 one by 2.3e-7.
    rel_close(got, ref, tol=1e-3, name="E gradient")
    assert all(p.grad is None for p in list(G.parameters()) + list(bis.parameters()))


def _write_data(root, n):
    rng = np.random.RandomState(1)
    imgs, segs = os.path.join(root, "imgs"), os.path.join(root, "segs")
    os.makedirs(imgs)
    os.makedirs(segs)
    labels = {}
    for i in range(n):
        name = f"img{i:08d}.png"
        PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(os.path.join(imgs, name))
        PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(os.path.join(segs, name))
        label = np.asarray(jrender.CANONICAL_POSE_25, np.float32).copy()
        label[[1, 2, 5, 6, 9, 10]] *= -1  # stored OpenCV-convention
        labels[name] = label.tolist()
    with open(os.path.join(imgs, "dataset.json"), "w") as f:
        json.dump({"labels": list(labels.items())}, f)
    return imgs, segs


@pytest.fixture(scope="module")
def arcface_file(tmp_path_factory):
    """ArcFace IR-SE50 weights from the JAX init, convs at half its std (at the
    init's std its activations grow ~1e6-fold and the id score moves by 3% with
    fp32 rounding alone, tests/test_torch_face_nets.py), in fp16 to keep the
    file small (the modules convert)."""
    sd = ArcFaceIRSE50().init().state_dict()
    folder = tmp_path_factory.mktemp("arcface")
    path = folder / "arcface.pth"
    torch.save({k: (v * 0.5 if v.ndim == 4 else v).half() if v.is_floating_point() else v
                for k, v in sd.items()}, path)
    yield str(path)
    shutil.rmtree(folder, ignore_errors=True)  # ~88 MB; tests/torch_tmp.py says why


def _trunk(module, prefixes, seed):
    """A state dict of the module's tensors under `prefixes`, N(0, 0.05²) weights."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) * 0.05
            for k, v in module.state_dict().items() if k.startswith(prefixes)}


def test_train_hybrid_encoder_cli_runs_and_resumes(tmp_path, arcface_file):
    """Both branches with BiSeNet, VGG19, LPIPS and ArcFace from files: one
    step and its snapshot; --resume of it restores E, Adam and the step (no
    step left to take)."""
    imgs, segs = _write_data(str(tmp_path), 2)
    files = {"bisenet": BiSeNet(20).init().state_dict(),
             "vgg-weights": _trunk(VGG16Features(cfg_name="vgg19"), ("features.",), 0),
             "lpips-weights": _trunk(LPIPS(), ("vgg.features.", "lin"), 1)}
    argv = ["--network", "random:0:tiny", "--data", imgs, "--seg", segs, "--batch", "1",
            "--snap", "1", "--device", "cpu", "--arcface-weights", arcface_file]
    for name, sd in files.items():  # fp16 files, to keep them small: the modules convert
        torch.save({k: v.half() if v.is_floating_point() else v for k, v in sd.items()},
                   tmp_path / f"{name}.pth")
        argv += [f"--{name}", str(tmp_path / f"{name}.pth")]
    out = str(tmp_path / "run")
    first = train_hybrid_encoder.main(argv + ["--outdir", out, "--max-steps", "1"])
    with open(os.path.join(out, "stats.jsonl")) as f:
        line = json.loads(f.readline())
    want = {"loss_ws", "loss_gen_l2", "loss_gen_entropy", "loss_cycle", "loss_real_l2", "loss_vgg",
            "loss_lpips", "loss_id", "loss_real_entropy", "loss_real_cycle", "loss_total"}
    assert want <= set(line) and all(np.isfinite(line[k]) for k in want) and line["step"] == 0
    snap = os.path.join(out, "encoder-00000001")
    saved, meta = load_checkpoint(snap)
    assert meta["step"] == 1 and first.step == 1
    fresh = HybridEncoder(size=R, n_latents_app=8, n_latents_geo=4).init(0)
    assert any(not torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                     first.E.state_dict().values()))
    resumed = train_hybrid_encoder.main(argv + ["--outdir", str(tmp_path / "r"), "--max-steps",
                                                "1", "--resume", snap])
    assert resumed.step == 1
    for k, v in saved["E"].items():
        assert torch.equal(resumed.E.state_dict()[k], v)
    torch.testing.assert_close(resumed.opt_e.state_dict(), saved["opt_e"], rtol=0, atol=0)


def _first_loss(text):
    return float(re.search(r"step 0: loss ([-0-9.e+]+)", text).group(1))


def test_finetune_cli_matches_jax(tmp_path, nets, capsys):
    """finetune_hybrid_encoder on the bridged G and E (written as snapshots):
    the step-0 loss it prints against the JAX CLI's loss_fn
    (apps/finetune_hybrid_encoder.py) written from the JAX package's pieces on
    the same weights, image, mask and target code; its file, E moved and finite."""
    jG, gp, G, jE, ep, E, bp, bis = nets
    rng = np.random.RandomState(5)
    PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(tmp_path / "img.png")
    PIL.Image.fromarray(rng.randint(0, 19, (R, R), np.uint8)).save(tmp_path / "mask.png")
    code = rng.randn(1, 12, 512).astype(np.float32) * 0.3
    np.savez(tmp_path / "code.npz", ws=code)
    save_checkpoint(str(tmp_path / "G"), {"G_ema": G.state_dict()}, config=G.cfg)
    save_checkpoint(str(tmp_path / "E"), {"E": E.state_dict()})
    finetune_hybrid_encoder.main([
        "--network", str(tmp_path / "G"), "--encoder", str(tmp_path / "E"), "--img",
        str(tmp_path / "img.png"), "--mask", str(tmp_path / "mask.png"), "--target-code",
        str(tmp_path / "code.npz"), "--steps", "1", "--outdir", str(tmp_path / "port"),
        "--device", "cpu"])
    got = _first_loss(capsys.readouterr().out)

    img = jnp.asarray(jinfer.load_image(str(tmp_path / "img.png"), R))[None]
    seg = jmask2onehot(jnp.asarray(jinfer.load_mask(str(tmp_path / "mask.png"), R))[None]) * 2.0 - 1.0
    c = jnp.asarray(jrender.CANONICAL_POSE_25)[None]
    w_avg = gp["mapping"]["w_avg"][None, None, :]

    def loss_fn(e_params):  # the JAX CLI's, line for line
        rec_ws = jE(e_params, img, seg) + w_avg
        l_ws = jL.smooth_l1(rec_ws, jnp.asarray(code)) * 50.0
        rec_img, rec_seg = jG.synthesis(gp["synthesis"], rec_ws, c, return_seg=True)
        cyc_ws = jE(e_params, img, jnp.tanh(rec_seg)) + w_avg
        return l_ws + jL.l2(rec_img, img) + jL.smooth_l1(jax.lax.stop_gradient(rec_ws), cyc_ws)

    ref = float(jax.jit(loss_fn)(ep))
    assert abs(got - ref) <= 1e-4 * abs(ref) + 1e-4  # printed to 4 decimals
    state, _ = load_checkpoint(str(tmp_path / "port" / "finetuned_encoder"))
    moved = [not torch.equal(state["E"][k], v) for k, v in E.state_dict().items()]
    assert any(moved) and all(torch.isfinite(v).all() for v in state["E"].values())


def test_calc_losses_cli_matches_jax(tmp_path, arcface_file):
    """l2, lpips (weight file) and miou against the JAX CLI on two image pairs;
    id (ArcFace weight file) against the mean and std of the cosine of the
    port's ArcFace embeddings of the pairs, the JAX CLI's formula."""
    rng = np.random.RandomState(6)
    for d in ("a", "b", "ma", "mb"):
        os.makedirs(tmp_path / d)
    for i in range(2):
        for d in ("a", "b"):
            PIL.Image.fromarray(rng.randint(0, 255, (R, R, 3), np.uint8)).save(tmp_path / d / f"{i}.png")
            PIL.Image.fromarray(rng.randint(0, 4, (R, R), np.uint8)).save(tmp_path / f"m{d}" / f"{i}.png")
    lp = _trunk(LPIPS(), ("vgg.features.",), 2)
    lp.update({f"lin{i}.weight": torch.from_numpy(rng.rand(c).astype(np.float32) * 0.1)
               for i, c in enumerate((64, 128, 256, 512, 512))})
    torch.save(lp, tmp_path / "lpips.pth")
    argv = ["--data-a", str(tmp_path / "a"), "--data-b", str(tmp_path / "b"), "--masks-a",
            str(tmp_path / "ma"), "--masks-b", str(tmp_path / "mb"), "--resolution", str(R),
            "--lpips-weights", str(tmp_path / "lpips.pth"), "--arcface-weights", arcface_file]
    ref = jcalc.main(argv + ["--mode", "l2,lpips,miou"])
    got = calc_losses_on_images.main(argv + ["--mode", "l2,lpips,id,miou", "--device", "cpu",
                                             "--output", str(tmp_path / "r.json")])
    assert set(got) == {"l2", "lpips", "id", "miou"} and set(ref) == {"l2", "lpips", "miou"}
    arc = load_state_dict_file(ArcFaceIRSE50(), arcface_file).eval()
    with torch.no_grad():
        e = [F.normalize(arc.embed_faces(torch.from_numpy(np.stack(
            [jinfer.load_image(str(tmp_path / d / f"{i}.png"), R) for i in range(2)]))), dim=-1)
            for d in ("a", "b")]
    cos = (e[0] * e[1]).sum(-1).numpy()
    ref["id"] = {"mean": float(cos.mean()), "std": float(cos.std())}
    for m in got:
        for k in ("mean", "std"):
            np.testing.assert_allclose(got[m][k], ref[m][k], rtol=1e-4, atol=1e-7, err_msg=m)
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == got
