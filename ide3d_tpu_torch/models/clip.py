"""CLIP ViT-B/32 (image + text towers): the embedder behind StyleCLIP and NADA.

Counterpart of ide3d_tpu/models/clip.py, with its contracts (the reference
consumes OpenAI CLIP through the `clip` package):
  * inversion/networks.py:1800-1819 (CLIPEncoder: the ViT-B/32 visual tower
    over a bicubic-resized, CLIP-normalized image),
  * StyleCLIP's criteria/clip_loss.py:1-17 (CLIPLoss: nearest upsample x7 +
    average pool to 224, similarity = 1 - logits_per_image / 100),
  * StyleCLIP's mapper coach (`clip.tokenize`).

The module's parameters carry the OpenAI state-dict names in torch's layouts
(`attn.in_proj_weight` [3D, D], linear weights [out, in], conv1 OIHW), so an
OpenAI state dict loads as it is. The towers are pre-LN transformer blocks
with QuickGELU; attention is F.scaled_dot_product_attention, the text tower's
with the causal mask. The model runs in fp32 unless asked otherwise, as the
JAX package's `load_clip`. The byte-level BPE tokenizer is host code, a copy
of the JAX package's. No CLIP weights or BPE vocab ship with the repo.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import html
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# CLIP image normalization constants (inversion/networks.py:1816).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    """ViT-B/32 defaults (the only variant the reference loads)."""

    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: int = 12
    vision_width: int = 768
    vision_patch_size: int = 32
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_layers: int = 12
    head_dim: int = 64

    @property
    def vision_heads(self) -> int:
        return self.vision_width // self.head_dim

    @property
    def transformer_heads(self) -> int:
        return self.transformer_width // self.head_dim

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size


# ------------------------------------------------------------------ the towers


class _Attention(nn.Module):
    """nn.MultiheadAttention's parameters (self-attention), [B, L, D] in and out."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        B, L, D = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(B, L, self.n_heads, D // self.n_heads).transpose(1, 2)
                   for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class _Mlp(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = nn.Linear(d, 4 * d)
        self.c_proj = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU, as OpenAI CLIP


class _ResBlock(nn.Module):
    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(d)
        self.attn = _Attention(d, n_heads)
        self.ln_2 = nn.LayerNorm(d)
        self.mlp = _Mlp(d)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, d: int, layers: int, n_heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList([_ResBlock(d, n_heads) for _ in range(layers)])

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class _Visual(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        w = cfg.vision_width
        self.conv1 = nn.Conv2d(3, w, cfg.vision_patch_size, cfg.vision_patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.grid_size ** 2 + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = _Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))


class CLIP(nn.Module):
    """The OpenAI CLIP model (ViT visual tower); parameter names as its state dict."""

    def __init__(self, cfg: ClipConfig = ClipConfig()):
        super().__init__()
        self.cfg = cfg
        tw = cfg.transformer_width
        self.visual = _Visual(cfg)
        self.transformer = _Transformer(tw, cfg.transformer_layers, cfg.transformer_heads)
        self.token_embedding = nn.Embedding(cfg.vocab_size, tw)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, tw))
        self.ln_final = nn.LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    @property
    def dtype(self) -> torch.dtype:
        return self.visual.conv1.weight.dtype

    @torch.no_grad()
    def init(self, seed: int = 0) -> "CLIP":
        """Random weights with the JAX package's scale scheme, drawn from a CPU
        torch.Generator seeded with `seed` (the same weights on every device; not
        the JAX package's numbers): projections N(0, 1/d) (c_fc 1/(2d)), the
        token table N(0, 0.02²), the text positions N(0, 0.01²), identity
        LayerNorms, zero biases, logit scale log(1/0.07). For tests and
        stand-in weight files; real use loads the OpenAI state dict. Returns self."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        cfg = self.cfg

        def normal(p: torch.Tensor, std: float) -> None:
            p.copy_(torch.randn(p.shape, generator=gen) * std)

        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _ResBlock):
                d = m.ln_1.weight.shape[0]
                normal(m.attn.in_proj_weight, d ** -0.5)
                m.attn.in_proj_bias.zero_()
                normal(m.attn.out_proj.weight, d ** -0.5)
                m.attn.out_proj.bias.zero_()
                normal(m.mlp.c_fc.weight, (2 * d) ** -0.5)
                m.mlp.c_fc.bias.zero_()
                normal(m.mlp.c_proj.weight, d ** -0.5)
                m.mlp.c_proj.bias.zero_()
        vw, tw = cfg.vision_width, cfg.transformer_width
        normal(self.visual.conv1.weight, vw ** -0.5)
        normal(self.visual.class_embedding, vw ** -0.5)
        normal(self.visual.positional_embedding, vw ** -0.5)
        normal(self.visual.proj, vw ** -0.5)
        normal(self.token_embedding.weight, 0.02)
        normal(self.positional_embedding, 0.01)
        normal(self.text_projection, tw ** -0.5)
        self.logit_scale.fill_(math.log(1.0 / 0.07))
        return self

    # --------------------------------------------------------------- encoders

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, R, R, 3] NHWC, already preprocessed (see `preprocess`) ->
        [B, embed_dim], unnormalized as torch's `encode_image`."""
        v = self.visual
        x = v.conv1(x.to(self.dtype).permute(0, 3, 1, 2))  # [B, W, g, g]
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, g*g, W], patches row-major
        cls = v.class_embedding.to(x.dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + v.positional_embedding.to(x.dtype)
        x = v.transformer(v.ln_pre(x))
        return v.ln_post(x[:, 0]) @ v.proj

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, context_length] int -> [B, embed_dim], the features at
        the EOT token (the highest id of each row)."""
        x = self.token_embedding(tokens.long()) + self.positional_embedding
        x = self.ln_final(self.transformer(x, causal=True))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection

    def forward(self, image: torch.Tensor, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits_per_image, logits_per_text), as the torch model."""
        ei = self.encode_image(image)
        et = self.encode_text(tokens)
        ei = ei / torch.linalg.vector_norm(ei, dim=-1, keepdim=True)
        et = et / torch.linalg.vector_norm(et, dim=-1, keepdim=True)
        logits = self.logit_scale.exp().to(ei.dtype) * ei @ et.t()
        return logits, logits.t()

    # ---------------------------------------------------------- preprocessing

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """CLIPEncoder.preprocess_tensor (inversion/networks.py:1811-1817):
        x in [-1, 1] NHWC -> [0, 1] -> bicubic resize to R x R -> normalize.
        The resize is jax.image.resize(..., "cubic"): Keys' a = -0.5 with the
        weights renormalized at the borders, widened by the scale when
        shrinking, which is F.interpolate's antialiased bicubic both ways."""
        R = self.cfg.image_resolution
        x = x * 0.5 + 0.5
        if x.shape[1] != R or x.shape[2] != R:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(R, R), mode="bicubic",
                              align_corners=False, antialias=True).permute(0, 2, 3, 1)
        mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
        return (x - mean) / std

    def preprocess_pool(self, x: torch.Tensor) -> torch.Tensor:
        """CLIPLoss's resize (clip_loss.py:10-15): nearest upsample x7, then an
        average pool of k = 7 S / R; the raw pooled tensor, not normalized (the
        reference feeds it to the visual tower as it is)."""
        S, R = x.shape[1], self.cfg.image_resolution
        k = S * 7 // R
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=7, mode="nearest")
        return F.avg_pool2d(up, k).permute(0, 2, 3, 1)


# --------------------------------------------------------------------- import


def config_from_state_dict(sd: Dict[str, torch.Tensor], head_dim: int = 64) -> ClipConfig:
    """The architecture of a (ViT) CLIP state dict, from shapes, as the OpenAI
    loader's build_model; the head count is not in the shapes, OpenAI's is 64-dim heads."""
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_patch = sd["visual.conv1.weight"].shape[-1]
    vision_layers = 1 + max(int(k.split(".")[3]) for k in sd
                            if k.startswith("visual.transformer.resblocks."))
    grid = int(round(math.sqrt(sd["visual.positional_embedding"].shape[0] - 1)))
    text_layers = 1 + max(int(k.split(".")[2]) for k in sd
                          if k.startswith("transformer.resblocks."))
    width = sd["ln_final.weight"].shape[0]
    if width % head_dim or vision_width % head_dim:
        raise ValueError(f"head_dim {head_dim} does not divide tower widths")
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * vision_patch,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width,
        transformer_layers=text_layers,
        head_dim=head_dim,
    )


def import_clip(sd: Dict[str, Union[torch.Tensor, np.ndarray]], dtype: str = "float32",
                head_dim: int = 64) -> CLIP:
    """OpenAI CLIP state dict -> CLIP in `dtype`, on the CPU. Only ViT visual
    towers (the reference only loads ViT-B/32); the JIT archive's scalar
    entries (input_resolution, context_length, vocab_size) are skipped."""
    if "visual.conv1.weight" not in sd:
        raise ValueError("only ViT CLIP checkpoints are supported (no visual.conv1)")
    sd = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, np.ndarray) else v
          for k, v in sd.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    model = CLIP(config_from_state_dict(sd, head_dim=head_dim))
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    return model.to(getattr(torch, dtype))


def load_clip(path: str, dtype: str = "float32", device: Union[torch.device, str] = "cuda") -> CLIP:
    """A torch.save'd CLIP state dict (e.g. `clip.load(...)[0].state_dict()`),
    read by the stub reader (io.load_torch_file_stubbed: nothing in the file
    runs) -> CLIP on `device` in eval mode."""
    from ..io.torch_import import load_torch_file_stubbed, state_dict_of

    return import_clip(state_dict_of(load_torch_file_stubbed(path)), dtype=dtype).to(device).eval()


# ------------------------------------------------------------------ tokenizer


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte->printable-unicode table (the published BPE convention):
    printable ASCII/latin bytes map to themselves, the rest to 256+i."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _word_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


_TOKEN_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE | re.UNICODE,
)


class SimpleTokenizer:
    """Byte-level BPE tokenizer with CLIP's vocab layout:
    256 byte tokens + 256 byte+'</w>' tokens + merge tokens + 2 specials.

    `bpe_path` points at the standard `bpe_simple_vocab_16e6.txt.gz`; `merges`
    supplies the pair list directly (tests). The token regex approximates the
    reference's \\p{L}/\\p{N} classes with re's unicode word classes, identical
    on ASCII prompts, which is all the reference's 14 named edits and NADA
    prompts use.
    """

    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[Sequence[Tuple[str, str]]] = None):
        if merges is None:
            if bpe_path is None:
                raise ValueError("need bpe_path or merges")
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # CLIP uses merge lines 1 .. 49152-256-2 inclusive.
            merges = [tuple(line.split()) for line in lines[1: 49152 - 256 - 2 + 1]]
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache = {"<|startoftext|>": "<|startoftext|>",
                       "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _word_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            pair = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if pair not in self.bpe_ranks:
                break
            a, b = pair
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _word_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    @staticmethod
    def _clean(text: str) -> str:
        try:  # ftfy mojibake fixing, if present (optional in the reference too)
            import ftfy

            text = ftfy.fix_text(text)
        except ImportError:
            pass
        text = html.unescape(html.unescape(text))
        return re.sub(r"\s+", " ", text.strip()).lower()

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _TOKEN_PATTERN.findall(self._clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77, truncate: bool = False) -> np.ndarray:
        """`clip.tokenize` contract: [N, context_length] int32 with SOT/EOT."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"input too long for context {context_length}: {text!r}")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out


# ---------------------------------------------------------------- loss helpers


def clip_similarity_loss(model: CLIP, image: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """CLIPLoss.forward (clip_loss.py:13-16): the pooled resize of the [-1, 1]
    image, 1 - logits_per_image / 100. Returns [B, N_text]."""
    logits, _ = model(model.preprocess_pool(image), tokens)
    return 1.0 - logits / 100.0


def make_image_embedder(model: CLIP):
    """NADA's embedder: [-1, 1] NHWC image -> [B, D] (the bicubic
    preprocessing, the CLIPEncoder pathway)."""

    def embed(img: torch.Tensor) -> torch.Tensor:
        return model.encode_image(model.preprocess(img))

    return embed


def text_direction(model: CLIP, tokenizer: SimpleTokenizer, source: str,
                   target: str) -> torch.Tensor:
    """Normalized E_txt(target) - E_txt(source), for NADA (train/nada.py)."""
    dev = model.token_embedding.weight.device
    toks = torch.as_tensor(tokenizer.tokenize(
        [source, target], context_length=model.cfg.context_length, truncate=True), device=dev)
    emb = model.encode_text(toks)
    emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    d = emb[1] - emb[0]
    return d / (torch.linalg.vector_norm(d) + 1e-8)
