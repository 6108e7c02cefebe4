"""The port's CLIP (``tgi_torch/models/clip.py``), its tokenizer and the
CLIP loss (``tgi_torch/losses/clip_loss.py``) against ``tgi``'s, on the
CPU in fp32.

No checkpoint or merges file can be downloaded: the weights are drawn
with the port's init at a small config (tests/test_clip.py's), written as
a state dict in both published layouts (HF ``CLIPModel`` and OpenAI
``clip``) and read by both packages' converters; the tokenizer reads a
small merges file, gz and plain. Tolerances: logits and embeddings within
1e-5 of the largest value (a few layers of fp32 matmuls and softmaxes in
another order); the loss 1e-5; the pool 1e-6; both layouts convert to
the same tree bit for bit; the tokenizer's ids exactly.
"""

import gzip

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tgi.io.validate import expected_spec as jexpected_spec
from tgi.losses.clip_loss import clip_loss as jclip_loss
from tgi.losses.clip_loss import clip_pool as jclip_pool
from tgi.models import clip as jclip
from tgi_torch.io.validate import expected_spec, tree_spec, validate_tree
from tgi_torch.losses import clip_loss, clip_pool
from tgi_torch.models import clip

TINY = dict(embed_dim=20, image_size=32, patch_size=16, vision_width=32,
            vision_layers=2, vision_heads=2, vocab_size=64,
            context_length=16, text_width=24, text_layers=2, text_heads=2)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def hf_state_dict(seed=0, cfg=clip.ClipConfig(**TINY)):
    """The port's drawn weights as an HF CLIPModel state dict (with the
    buffers a real dump carries)."""
    params = clip.clip_init(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")
    sd = _flat(params)
    sd["text_model.embeddings.position_ids"] = torch.arange(
        cfg.context_length)[None]
    return sd


def openai_state_dict(hf):
    """An HF state dict in the OpenAI clip package's names and layout
    (q, k, v packed into ``in_proj``, projections stored transposed)."""
    out, qkv = {}, {}
    for name, v in hf.items():
        if "position_ids" in name:
            continue
        for tower, pfx in (("vision_model.", "visual.transformer."),
                           ("text_model.", "transformer.")):
            key = tower + "encoder.layers."
            if name.startswith(key):
                i, sub = name[len(key):].split(".", 1)
                base = f"{pfx}resblocks.{i}."
                if sub.startswith("self_attn.") and "out_proj" not in sub:
                    _, proj, kind = sub.split(".")
                    qkv.setdefault((base, kind), {})[proj] = v
                else:
                    out[base + (sub
                                .replace("self_attn.out_proj",
                                         "attn.out_proj")
                                .replace("layer_norm1", "ln_1")
                                .replace("layer_norm2", "ln_2")
                                .replace("mlp.fc1", "mlp.c_fc")
                                .replace("mlp.fc2", "mlp.c_proj"))] = v
                break
        else:
            inverse = {v: k for k, v in clip._OPENAI_SIMPLE.items()}
            if name in inverse:
                out[inverse[name]] = v
            elif name == "visual_projection.weight":
                out["visual.proj"] = v.T
            elif name == "text_projection.weight":
                out["text_projection"] = v.T
    for (base, kind), parts in qkv.items():
        out[base + "attn.in_proj_" + kind] = torch.cat(
            [parts["q_proj"], parts["k_proj"], parts["v_proj"]])
    out["visual.transformer.resblocks.0.attn_mask"] = torch.zeros(1)
    return out


def _inputs():
    rng = np.random.RandomState(1)
    px = rng.randn(2, 3, 32, 32).astype(np.float32)
    ids = rng.randint(1, 62, size=(3, 16))
    for r, pos in enumerate([5, 9, 15]):   # one end token (63) per row
        ids[r, pos] = 63
        ids[r, pos + 1:] = 0
    return px, ids.astype(np.int32)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("layout", ["hf", "openai"])
def test_clip_apply_matches_tgi(layout):
    """The towers and logits from either layout's state dict, read by
    each package's converter."""
    cfg_t, cfg_j = clip.ClipConfig(**TINY), jclip.ClipConfig(**TINY)
    sd = hf_state_dict()
    if layout == "openai":
        sd = openai_state_dict(sd)
    got_p = clip.convert_torch_state_dict(sd, device="cpu")
    validate_tree(got_p, expected_spec(clip.clip_init, None, cfg_t), "clip")
    want_p = jclip.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    px, ids = _inputs()
    got = clip.clip_apply(got_p, torch.from_numpy(px), torch.from_numpy(ids),
                          cfg_t)
    want = jclip.clip_apply(want_p, jnp.asarray(px), jnp.asarray(ids), cfg_j)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    _close(clip.encode_image(got_p, torch.from_numpy(px), cfg_t),
           jclip.encode_image(want_p, jnp.asarray(px), cfg_j), 1e-5)
    _close(clip.encode_text(got_p, torch.from_numpy(ids), cfg_t),
           jclip.encode_text(want_p, jnp.asarray(ids), cfg_j), 1e-5)


def test_both_layouts_convert_to_the_same_tree():
    hf = hf_state_dict(seed=3)
    a = _flat(clip.convert_torch_state_dict(hf, device="cpu"))
    b = _flat(clip.convert_torch_state_dict(openai_state_dict(hf),
                                            device="cpu"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # The duplicated tower level of some HF dumps collapses.
    nested = {k.replace("text_model.", "text_model.text_model.", 1): v
              for k, v in hf.items()}
    c = _flat(clip.convert_torch_state_dict(nested, device="cpu"))
    assert c.keys() == a.keys()


def test_full_width_tree_matches_tgi():
    """ViT-B/32's tree (151 M weights) on the meta device against tgi's
    ``jax.eval_shape``."""
    got = expected_spec(clip.clip_init, None, clip.ClipConfig())
    want = jexpected_spec(lambda: jclip.clip_init(jax.random.PRNGKey(0)))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert sum(int(np.prod(s)) for s in got.values()) == 151277313
    assert tree_spec(clip.clip_init(torch.Generator().manual_seed(0),
                                    clip.ClipConfig(**TINY), "cpu")) == \
        expected_spec(clip.clip_init, None, clip.ClipConfig(**TINY))


def _merges(tmp_path):
    lines = ["#version: tiny", "h e", "l l", "he ll", "o</w> !</w>",
             "hell o</w>", "c a", "ca f", "w o", "r l", "wo rl", "worl d</w>"]
    p = tmp_path / "merges.txt"
    p.write_text("\n".join(lines) + "\n")
    gz = tmp_path / "merges.txt.gz"
    with gzip.open(gz, "wb") as f:
        f.write(p.read_bytes())
    return str(p), str(gz)


TEXTS = ["Hello  HELLO", "hello world!", "café! it's 42 &amp; done",
         "a photo of a face with a smile",
         "hello " * 30]


@pytest.mark.parametrize("kind", ["plain", "gz"])
def test_tokenizer_matches_tgi(tmp_path, kind):
    path = _merges(tmp_path)[kind == "gz"]
    got, want = clip.SimpleTokenizer(path), jclip.SimpleTokenizer(path)
    assert got.encoder == want.encoder
    for text in TEXTS:
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.decode(ids) == want.decode(ids)
        assert got.bpe("hello") == want.bpe("hello") == "hello</w>"
    for ctx in (4, 77):
        t = got.tokenize(TEXTS, context_length=ctx)
        assert t.dtype == torch.int64
        assert np.array_equal(t.numpy(),
                              np.asarray(want.tokenize(TEXTS, ctx)))


def test_clip_pool_and_loss_match_tgi():
    """The pool against tgi's and against the reference's modules
    (Upsample x7 nearest, AvgPool2d); the loss formula against tgi's on
    the same weights."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    pool = torch.nn.AvgPool2d(kernel_size=64 // 32)
    ref = pool(torch.nn.Upsample(scale_factor=7)(torch.from_numpy(x)))
    got = clip_pool(torch.from_numpy(x))
    _close(got, ref.numpy(), 1e-6)
    _close(got, jclip_pool(jnp.asarray(x)), 1e-6)

    cfg_t, cfg_j = clip.ClipConfig(**TINY), jclip.ClipConfig(**TINY)
    sd = hf_state_dict(seed=4)
    pt = clip.convert_torch_state_dict(sd, device="cpu")
    pj = jclip.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    img = rng.randn(1, 3, 32, 32).astype(np.float32)
    _, ids = _inputs()
    got = clip_loss(pt, torch.from_numpy(img), torch.from_numpy(ids), cfg_t,
                    stylegan_size=224)
    want = jclip_loss(pj, jnp.asarray(img), jnp.asarray(ids), cfg_j,
                      stylegan_size=224)
    _close(got, want, 1e-5)
    logits, _ = clip.clip_apply(pt, clip_pool(torch.from_numpy(img), 224),
                                torch.from_numpy(ids), cfg_t)
    assert torch.equal(got, 1.0 - logits / 100.0)
