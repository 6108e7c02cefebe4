"""CLIP ViT-B/32 dual encoder (image + text) with its BPE tokenizer (twin
of ``tgi/models/clip.py``).

Behavioral parity target: the reference's criteria/clip_loss.py:6-18 loads
``clip.load("ViT-B/32")`` and evaluates ``model(image, text)[0]`` =
``logits_per_image``. The model is a params tree in the HuggingFace
``transformers.CLIPModel`` naming (``tgi``'s), with
:func:`convert_torch_state_dict` reading either published layout from a
plain state dict:

- HuggingFace ``CLIPModel`` (``vision_model.encoder.layers.N.self_attn.
  q_proj...``), and
- the OpenAI ``clip`` package (``visual.transformer.resblocks.N.attn.
  in_proj_weight...``), told apart as ``tgi`` tells them
  (``visual.conv1``) and renamed onto the HF names.

Neither ``transformers`` nor ``clip`` is imported: the reader takes the
state dict (``torch.load`` of the user's file).

Architecture (both implementations agree): pre-LN transformer blocks,
QuickGELU ``x * sigmoid(1.702 x)``, LayerNorm eps 1e-5, an explicit
softmax attention (causal in the text tower); the vision tower's 32x32
stride-32 patch convolution without bias, a CLS token, learned positions,
LayerNorm before the blocks and on the CLS state, a projection without
bias; the text tower's final LayerNorm and pooling at
``argmax(token_ids)`` (``<|endoftext|>``, 49407, is the largest id);
``logits_per_image = exp(logit_scale) * norm(img) @ norm(txt).T``.

The tokenizer is OpenAI's byte-level BPE (``clip/simple_tokenizer.py``)
fed by the published merges file ``bpe_simple_vocab_16e6.txt.gz`` (gz or
plain), which users supply; as in ``tgi``, ``ftfy`` is replaced by NFC
normalisation, the same on clean ASCII prompts.
"""

from __future__ import annotations

import functools
import gzip
import html
import math
import re
import unicodedata
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ClipConfig:
    """ViT-B/32 by default; fields sized down freely for tests."""
    embed_dim: int = 512
    # vision tower
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text tower
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8


# ---------------------------------------------------------------------------
# init


def _normal(generator, shape, device, std=0.02):
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32).to(device) * std


def _ln_init(d, device):
    return {"weight": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def _linear_init(generator, d_in, d_out, device):
    return {"weight": _normal(generator, (d_out, d_in), device),
            "bias": torch.zeros((d_out,), device=device)}


def _layer_init(generator, width, device, mlp_ratio=4):
    attn = {name: _linear_init(generator, width, width, device)
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
    return {
        "self_attn": attn,
        "layer_norm1": _ln_init(width, device),
        "layer_norm2": _ln_init(width, device),
        "mlp": {"fc1": _linear_init(generator, width, width * mlp_ratio,
                                    device),
                "fc2": _linear_init(generator, width * mlp_ratio, width,
                                    device)},
    }


def clip_init(generator, cfg: ClipConfig = ClipConfig(), device="cuda"):
    """Random weights from ``generator`` (a CPU ``torch.Generator``) in the
    HF CLIPModel names, with ``tgi``'s shapes and distributions: N(0,
    0.02²) weights, zero biases, unit LayerNorms, ``logit_scale``
    ln(1/0.07)."""
    grid = cfg.image_size // cfg.patch_size
    vision = {
        "embeddings": {
            "class_embedding": _normal(generator, (cfg.vision_width,),
                                       device),
            "patch_embedding": {"weight": _normal(
                generator, (cfg.vision_width, 3, cfg.patch_size,
                            cfg.patch_size), device)},
            "position_embedding": {"weight": _normal(
                generator, (grid * grid + 1, cfg.vision_width), device)},
        },
        "pre_layrnorm": _ln_init(cfg.vision_width, device),  # HF's spelling
        "encoder": {"layers": {
            str(i): _layer_init(generator, cfg.vision_width, device)
            for i in range(cfg.vision_layers)}},
        "post_layernorm": _ln_init(cfg.vision_width, device),
    }
    text = {
        "embeddings": {
            "token_embedding": {"weight": _normal(
                generator, (cfg.vocab_size, cfg.text_width), device)},
            "position_embedding": {"weight": _normal(
                generator, (cfg.context_length, cfg.text_width), device)},
        },
        "encoder": {"layers": {
            str(i): _layer_init(generator, cfg.text_width, device)
            for i in range(cfg.text_layers)}},
        "final_layer_norm": _ln_init(cfg.text_width, device),
    }
    return {
        "logit_scale": torch.tensor(2.6592, device=device),
        "vision_model": vision,
        "text_model": text,
        "visual_projection": {"weight": _normal(
            generator, (cfg.embed_dim, cfg.vision_width), device)},
        "text_projection": {"weight": _normal(
            generator, (cfg.embed_dim, cfg.text_width), device)},
    }


# ---------------------------------------------------------------------------
# apply


def _ln(p, x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["weight"] + p["bias"]


def _linear(p, x):
    return x @ p["weight"].T + p["bias"]


def _attention(p, x, heads, causal=False):
    n, L, d = x.shape
    hd = d // heads
    q = _linear(p["q_proj"], x).reshape(n, L, heads, hd)
    k = _linear(p["k_proj"], x).reshape(n, L, heads, hd)
    v = _linear(p["v_proj"], x).reshape(n, L, heads, hd)
    scores = torch.einsum("nqhd,nkhd->nhqk", q, k) * (hd ** -0.5)
    if causal:
        mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, L, d)
    return _linear(p["out_proj"], out)


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _block(p, x, heads, causal):
    x = x + _attention(p["self_attn"], _ln(p["layer_norm1"], x), heads,
                       causal)
    h = _quick_gelu(_linear(p["mlp"]["fc1"], _ln(p["layer_norm2"], x)))
    return x + _linear(p["mlp"]["fc2"], h)


def encode_image(params, pixels, cfg: ClipConfig = ClipConfig()):
    """pixels: [N, 3, H, W] -> [N, embed_dim] (unnormalized)."""
    vm = params["vision_model"]
    patches = F.conv2d(pixels, vm["embeddings"]["patch_embedding"]["weight"],
                       stride=cfg.patch_size)
    n, w, gh, gw = patches.shape
    x = patches.reshape(n, w, gh * gw).permute(0, 2, 1)
    cls = vm["embeddings"]["class_embedding"].expand(n, 1, w)
    x = torch.cat([cls, x], dim=1)
    x = x + vm["embeddings"]["position_embedding"]["weight"]
    x = _ln(vm["pre_layrnorm"], x)
    for i in range(cfg.vision_layers):
        x = _block(vm["encoder"]["layers"][str(i)], x, cfg.vision_heads,
                   causal=False)
    pooled = _ln(vm["post_layernorm"], x[:, 0])
    return pooled @ params["visual_projection"]["weight"].T


def encode_text(params, token_ids, cfg: ClipConfig = ClipConfig()):
    """token_ids: [N, L] integers -> [N, embed_dim] (unnormalized)."""
    tm = params["text_model"]
    token_ids = token_ids.long()
    x = tm["embeddings"]["token_embedding"]["weight"][token_ids]
    x = x + tm["embeddings"]["position_embedding"]["weight"][
        :token_ids.shape[1]]
    for i in range(cfg.text_layers):
        x = _block(tm["encoder"]["layers"][str(i)], x, cfg.text_heads,
                   causal=True)
    x = _ln(tm["final_layer_norm"], x)
    pooled = x[torch.arange(x.shape[0], device=x.device),
               token_ids.argmax(dim=-1)]
    return pooled @ params["text_projection"]["weight"].T


def clip_apply(params, pixels, token_ids, cfg: ClipConfig = ClipConfig()):
    """Return (logits_per_image [N_img, N_txt], logits_per_text)."""
    ie = encode_image(params, pixels, cfg)
    te = encode_text(params, token_ids.to(pixels.device), cfg)
    ie = ie / ie.norm(dim=-1, keepdim=True)
    te = te / te.norm(dim=-1, keepdim=True)
    logits_per_image = params["logit_scale"].exp() * ie @ te.T
    return logits_per_image, logits_per_image.T


# ---------------------------------------------------------------------------
# checkpoint converters


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        parts = name.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _array(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


# OpenAI clip-package names -> HF CLIPModel names, outside the blocks.
_OPENAI_SIMPLE = {
    "visual.class_embedding": "vision_model.embeddings.class_embedding",
    "visual.conv1.weight": "vision_model.embeddings.patch_embedding.weight",
    "visual.positional_embedding":
        "vision_model.embeddings.position_embedding.weight",
    "visual.ln_pre.weight": "vision_model.pre_layrnorm.weight",
    "visual.ln_pre.bias": "vision_model.pre_layrnorm.bias",
    "visual.ln_post.weight": "vision_model.post_layernorm.weight",
    "visual.ln_post.bias": "vision_model.post_layernorm.bias",
    "token_embedding.weight": "text_model.embeddings.token_embedding.weight",
    "positional_embedding": "text_model.embeddings.position_embedding.weight",
    "ln_final.weight": "text_model.final_layer_norm.weight",
    "ln_final.bias": "text_model.final_layer_norm.bias",
    "logit_scale": "logit_scale",
}


def _remap_openai(sd: dict) -> dict:
    """OpenAI clip-package names -> HF CLIPModel names (values adjusted)."""
    out: dict = {}

    def tower(prefix_in, prefix_out):
        rx = re.compile(re.escape(prefix_in) + r"transformer\.resblocks\."
                        r"(\d+)\.(.*)")
        for name in list(sd):
            m = rx.match(name)
            if not m:
                continue
            i, rest = m.group(1), m.group(2)
            base = f"{prefix_out}encoder.layers.{i}."
            v = _array(sd.pop(name))
            if rest.startswith("attn.in_proj_"):
                kind = rest[len("attn.in_proj_"):]  # weight | bias
                q, k, vv = np.split(v, 3, axis=0)
                for pn, pv in (("q_proj", q), ("k_proj", k), ("v_proj", vv)):
                    out[f"{base}self_attn.{pn}.{kind}"] = pv
            else:
                rest = (rest
                        .replace("attn.out_proj", "self_attn.out_proj")
                        .replace("ln_1", "layer_norm1")
                        .replace("ln_2", "layer_norm2")
                        .replace("mlp.c_fc", "mlp.fc1")
                        .replace("mlp.c_proj", "mlp.fc2"))
                out[base + rest] = v

    tower("visual.", "vision_model.")
    tower("", "text_model.")
    for src, dst in _OPENAI_SIMPLE.items():
        if src in sd:
            out[dst] = _array(sd.pop(src))
    # The projections are stored [width, embed] and used as x @ proj
    # upstream; HF stores the transpose and applies x @ W.T.
    if "visual.proj" in sd:
        out["visual_projection.weight"] = _array(sd.pop("visual.proj")).T
    if "text_projection" in sd:
        out["text_projection.weight"] = _array(sd.pop("text_projection")).T
    return out


def convert_torch_state_dict(sd: dict, device="cuda") -> dict:
    """An HF CLIPModel or OpenAI clip-package state dict (tensors or
    arrays) -> the params tree, float32 on ``device``."""
    sd = dict(sd)
    if any(k.startswith("visual.conv1") for k in sd):
        sd = _remap_openai(sd)
    flat = {}
    for name, v in sd.items():
        if ("position_ids" in name or "num_batches_tracked" in name
                or name.endswith("attn_mask")):
            continue
        # Some HF dumps carry the towers under text_model./vision_model.
        # twice (CLIPModel wraps CLIPTextTransformer at .text_model):
        # collapse the duplicate level.
        name = name.replace("text_model.text_model.", "text_model.") \
                   .replace("vision_model.vision_model.", "vision_model.")
        flat[name] = torch.from_numpy(np.array(_array(v))).to(device)
    return _nest(flat)


# ---------------------------------------------------------------------------
# tokenizer (OpenAI byte-level BPE; clip/simple_tokenizer.py semantics)


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return set(zip(word[:-1], word[1:]))


class SimpleTokenizer:
    """OpenAI CLIP BPE tokenizer fed by the published merges file.

    ``bpe_path``: ``bpe_simple_vocab_16e6.txt.gz`` (gzip or plain text).
    The vocabulary is derived from the merges exactly as upstream: 256
    byte symbols, their ``</w>`` forms, 48894 merge tokens and the two
    specials, 49408 entries for the published file.
    """

    def __init__(self, bpe_path: str):
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # \p{L} / \p{N} approximated with the standard re's classes.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE)

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        text = unicodedata.normalize("NFC", html.unescape(html.unescape(
            text)))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77):
        """``clip.tokenize``: int64 [N, context_length], truncating (the
        end token kept) and padding with 0."""
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = torch.zeros((len(texts), context_length), dtype=torch.int64)
        for row, text in enumerate(texts):
            ids = [sot] + self.encode(text)[:context_length - 2] + [eot]
            out[row, :len(ids)] = torch.tensor(ids)
        return out
