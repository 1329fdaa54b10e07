"""The port's CLIP (models/clip.py) against the JAX package's, on the CPU.

The tiny configuration of tests/test_clip.py, initialised by the JAX package
with its LayerNorms spread off the identity, bridged through
io/from_jax.load_jax_clip; the same inputs from a numpy seed through both.
The port's state dict carries the OpenAI names and layouts, so it also goes
back through the JAX package's own importer. The tokenizer runs on a
synthetic merges table (no BPE vocab ships with the repo), also read from a
.gz file as --bpe gives it. fp32 throughout; outputs within 1e-5 x max|output|.
"""

import gzip
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ide3d_tpu.models import clip as jclip
from ide3d_tpu_torch.io import load_torch_file_stubbed, state_dict_of
from ide3d_tpu_torch.io.from_jax import load_jax_clip
from ide3d_tpu_torch.models import clip as tclip
from torch_threads import module_one_intra_op_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-5  # x max|output|: fp32, the order of sums apart
CFG = dict(embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
           vision_patch_size=8, context_length=16, vocab_size=520, transformer_width=48,
           transformer_layers=2, head_dim=16)
MERGES = [("l", "o"), ("lo", "w"), ("lo", "w</w>"), ("e", "r</w>"), ("low", "er</w>")]


def rel_close(got, ref, tol=TOL, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all() and np.isfinite(ref).all(), name
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (name, err, scale)


@pytest.fixture(scope="module")
def bridged():
    """(JAX CLIP, its params, the port's CLIP with the same weights)."""
    jm = jclip.CLIP(cfg=jclip.ClipConfig(**CFG))
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.05 * rng.randn(*x.shape).astype(np.float32)
        if any(getattr(k, "key", "").startswith("ln_") for k in path) else x, params)
    m = load_jax_clip(tclip.CLIP(tclip.ClipConfig(**CFG)), jax.tree_util.tree_map(np.asarray, params))
    return jm, params, m.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(2)
    tok = jclip.SimpleTokenizer(merges=MERGES)
    return {"img": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
            "img64": rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32),
            "tokens": tok.tokenize(["low", "lower xy", "xy low er"], context_length=16)}


def test_towers_and_logits_match_jax(bridged, inputs):
    jm, p, m = bridged
    x, toks = inputs["img"], inputs["tokens"]
    with torch.no_grad():
        ei = m.encode_image(torch.from_numpy(x))
        et = m.encode_text(torch.from_numpy(toks))
        li, lt = m(torch.from_numpy(x), torch.from_numpy(toks))
    rel_close(ei, jm.encode_image(p, jnp.asarray(x)), name="encode_image")
    rel_close(et, jm.encode_text(p, jnp.asarray(toks)), name="encode_text")
    jli, jlt = jm(p, jnp.asarray(x), jnp.asarray(toks))
    rel_close(li, jli, name="logits_per_image")
    rel_close(lt, jlt, name="logits_per_text")


def test_state_dict_is_the_openai_layout(bridged, inputs, tmp_path):
    """The port's state dict goes through the JAX package's importer (OpenAI
    names and torch layouts) to the same function; config_from_state_dict
    reads the same config; a torch.save'd file of it, bare or under
    "state_dict", reads back through the stub reader as load_clip reads it
    (load_clip assumes OpenAI's 64-dim heads; this tiny CLIP has 16-dim ones)."""
    jm, p, m = bridged
    sd = {k: v.numpy() for k, v in m.state_dict().items()}
    assert tclip.config_from_state_dict(sd, head_dim=16) == tclip.ClipConfig(**CFG)
    jm2, p2 = jclip.import_clip(sd, head_dim=16)
    x = jnp.asarray(inputs["img"])
    rel_close(jm2.encode_image(p2, x), jm.encode_image(p, x), name="via the JAX importer")
    for i, obj in enumerate((m.state_dict(), {"state_dict": m.state_dict(), "epoch": 3})):
        path = str(tmp_path / f"clip{i}.pt")
        torch.save(obj, path)
        m2 = tclip.import_clip(state_dict_of(load_torch_file_stubbed(path)), head_dim=16)
        with torch.no_grad():
            assert torch.equal(m2.encode_text(torch.from_numpy(inputs["tokens"])),
                               m.encode_text(torch.from_numpy(inputs["tokens"])))
    with pytest.raises(ValueError):
        tclip.import_clip({k: v for k, v in sd.items() if k != "visual.conv1.weight"})


def test_preprocess_matches_jax(bridged, inputs):
    """The bicubic resize when shrinking (64 -> 32), enlarging (16 -> 32) and
    at the size, and the pooled resize (x7 nearest, k = 14)."""
    jm, _, m = bridged
    rng = np.random.RandomState(3)
    for x in (inputs["img64"], rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32), inputs["img"]):
        rel_close(m.preprocess(torch.from_numpy(x)), jm.preprocess(jnp.asarray(x)), name=x.shape)
    rel_close(m.preprocess_pool(torch.from_numpy(inputs["img64"])),
              jm.preprocess_pool(jnp.asarray(inputs["img64"])), name="pool")


def test_preprocess_at_full_width_matches_jax():
    """ViT-B/32's 224² input from the flagship's 512² image (the shrink
    jax.image.resize antialiases) and from a 32² one (the enlargement), and
    the pooled resize at k = 16."""
    jm = jclip.CLIP(cfg=jclip.ClipConfig())
    stub = types.SimpleNamespace(cfg=tclip.ClipConfig())
    rng = np.random.RandomState(4)
    for S in (512, 32):
        x = rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32)
        got = tclip.CLIP.preprocess(stub, torch.from_numpy(x))
        rel_close(got, jm.preprocess(jnp.asarray(x)), name=S)
    x = rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)
    rel_close(tclip.CLIP.preprocess_pool(stub, torch.from_numpy(x)),
              jm.preprocess_pool(jnp.asarray(x)), name="pool 512")


def test_loss_embedder_and_text_direction_match_jax(bridged, inputs):
    jm, p, m = bridged
    tok, jtok = tclip.SimpleTokenizer(merges=MERGES), jclip.SimpleTokenizer(merges=MERGES)
    x = inputs["img64"]
    with torch.no_grad():
        loss = tclip.clip_similarity_loss(m, torch.from_numpy(x), torch.from_numpy(inputs["tokens"]))
        emb = tclip.make_image_embedder(m)(torch.from_numpy(x))
        d = tclip.text_direction(m, tok, "low", "lower")
    rel_close(loss, jclip.clip_similarity_loss(jm, p, jnp.asarray(x), jnp.asarray(inputs["tokens"])),
              name="clip_similarity_loss")
    rel_close(emb, jclip.make_image_embedder(jm, p)(jnp.asarray(x)), name="embedder")
    rel_close(d, jclip.text_direction(jm, p, jtok, "low", "lower"), name="text_direction")
    assert abs(float(torch.linalg.vector_norm(d)) - 1.0) < 1e-5


@pytest.mark.parametrize("source", ["merges", "bpe_file"])
def test_tokenizer_matches_jax(tmp_path, source):
    """Exact ids, truncation and decoding against the JAX tokenizer, from the
    merges given and from a .gz vocab file in the published layout (a header
    line, then one merge a line)."""
    if source == "merges":
        tok, jtok = tclip.SimpleTokenizer(merges=MERGES), jclip.SimpleTokenizer(merges=MERGES)
    else:
        path = str(tmp_path / "bpe.txt.gz")
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
        tok, jtok = tclip.SimpleTokenizer(bpe_path=path), jclip.SimpleTokenizer(bpe_path=path)
    texts = ["low", "lower xy", "  LOW\t\nlow ", "a face with purple hair", "it's 3 o'clock!",
             "&amp; café"]
    np.testing.assert_array_equal(tok.tokenize(texts, context_length=48),
                                  jtok.tokenize(texts, context_length=48))
    for t in texts:
        assert tok.encode(t) == jtok.encode(t)
        assert tok.decode(tok.encode(t)) == jtok.decode(jtok.encode(t))
    np.testing.assert_array_equal(tok.tokenize("low " * 10, context_length=4, truncate=True),
                                  jtok.tokenize("low " * 10, context_length=4, truncate=True))
    with pytest.raises(RuntimeError):
        tok.tokenize("low " * 10, context_length=4)


def test_init_draws_the_jax_scales():
    """init(seed): the same weights for the same seed, the JAX init's scale
    scheme (projections N(0, 1/d), identity LayerNorms, zero biases)."""
    a, b = tclip.CLIP(tclip.ClipConfig(**CFG)).init(5), tclip.CLIP(tclip.ClipConfig(**CFG)).init(5)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = sa["visual.transformer.resblocks.0.attn.in_proj_weight"]
    assert abs(float(w.std()) - 64 ** -0.5) < 0.1 * 64 ** -0.5
    assert torch.equal(sa["ln_final.weight"], torch.ones(48))
    assert float(sa["transformer.resblocks.1.mlp.c_fc.bias"].abs().max()) == 0.0
    assert abs(float(sa["logit_scale"]) - np.log(1 / 0.07)) < 1e-6


def test_clip_module_leaves_jax_out():
    code = ("import sys, ide3d_tpu_torch.models.clip, ide3d_tpu_torch.editing.latent_editor, "
            "ide3d_tpu_torch.train.styleclip, ide3d_tpu_torch.train.nada, "
            "ide3d_tpu_torch.apps.styleclip_edit, ide3d_tpu_torch.apps.train_styleclip_mapper, "
            "ide3d_tpu_torch.apps.train_nada, ide3d_tpu_torch.apps.edit_comparison, "
            "ide3d_tpu_torch.apps.experiment_runner, ide3d_tpu_torch.apps.viz_renderer, "
            "ide3d_tpu_torch.apps.infer_face_animation, "
            "ide3d_tpu_torch.apps.converter_log_to_video; "
            "print('jax' in sys.modules, any(m.split('.')[0] == 'ide3d_tpu' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), timeout=120)
    assert out.stdout.split() == ["False", "False"]
