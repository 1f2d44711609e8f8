"""The port's decoder (classmate_rag_tpu_torch.models.decoder) against the
JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages. The
port computes as the reference does (bf16 operands, f32 sums, f32 norms,
softmax and logits), with sums in another order, so:

- parameters, quantized trees and configs must be EQUAL (bit for bit);
- logits agree within 1e-3 absolute with f32 compute; with bf16 and
  W8A8 compute one value on a rounding boundary may land a step apart
  (ATOL_ROUNDED, ATOL_W8A8); bf16 KV caches within one bf16 step;
- greedy token ids must be EQUAL, in all three families and with W8A8.

Sampled decoding cannot reproduce ``jax.random``; it is held to its
properties: the same seed gives the same tokens, every token lies inside
the top-p nucleus, temperature <= 0 and a vanishing top_p equal greedy.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classmate_rag_tpu.models import decoder as J
from classmate_rag_tpu_torch.models import decoder as T

# Logits of the f32-compute forward: f32 sums in another order (~1e-7).
ATOL = 1e-3
# Logits of the bf16 and W8A8 forwards: a value that sits on a rounding
# boundary — a bf16 cast of q, k, v, probs or an activation, or x / sx of
# an int8 activation — lands one step apart after upstream sums in
# another order, and moves its row's logits by up to ~2e-3 at this width
# (measured over 12 seeds: <= 1.6e-3; without such a flip ~1e-7).
ATOL_ROUNDED = 5e-3
# W8A8: an int8 activation one level apart (x / sx on a .5 boundary)
# moves every output of its product by sx * w, and a logit row by up to
# ~1e-2 (measured: <= 7.4e-3); through K and V the flip reaches every
# later position of its row.
ATOL_W8A8 = 2e-2
# KV caches are bf16 in both packages: an element may land one bf16 step
# (2^-7 relative at most) apart for the same reason.
CACHE_RTOL = 2.0 ** -7
FAMILIES = {
    "llama": {},
    "qwen2": dict(qkv_bias=True),
    "qwen3": dict(qk_norm=True, head_dim_override=24),
}
NEG = float(np.finfo(np.float32).min)


def _configs(family, **extra):
    kw = {**FAMILIES[family], **extra}
    return (dataclasses.replace(J.DecoderConfig.tiny_test(), **kw),
            dataclasses.replace(T.DecoderConfig.tiny_test(), **kw))


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("compute_dtype")
    # The port's DeepSeek-V2 fields (latent attention, sparse experts),
    # which the JAX package's config lacks: unset in the dense families.
    for key in ("mla", "moe"):
        if key in d:
            assert d.pop(key) is None, key
    return d


def _trees(family, seed_key="diff"):
    jc, tc = _configs(family)
    tree = T.init_params(tc, seed_key)
    return jc, tc, tree, jax.tree.map(jnp.asarray, tree)


def _prompts(seed=0, B=4, P=12, lens=(12, 7, 3, 10)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 512, (B, P)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    for i, n in enumerate(lens):
        ids[i, :P - n] = 0
    return ids, lens


def _jcache(c):
    """The JAX cache [L, B, S, KH, D] in the port's head-major order."""
    return np.asarray(c, np.float32).transpose(0, 1, 3, 2, 4)


@pytest.mark.parametrize("name", ["small", "tiny_test", "llama3_8b",
                                  "qwen2_7b", "qwen3_8b"])
def test_presets_equal(name):
    j, t = getattr(J.DecoderConfig, name)(), getattr(T.DecoderConfig, name)()
    assert _fields(j) == _fields(t)
    assert j.head_dim == t.head_dim
    assert t.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("raw", [
    {"model_type": "llama", "vocab_size": 100, "hidden_size": 32,
     "num_hidden_layers": 2, "num_attention_heads": 4,
     "intermediate_size": 64},
    {"model_type": "qwen2", "vocab_size": 100, "hidden_size": 32,
     "num_hidden_layers": 2, "num_attention_heads": 4,
     "num_key_value_heads": 2, "intermediate_size": 64,
     "rope_theta": 1e6, "rms_norm_eps": 1e-6},
    {"model_type": "qwen3", "vocab_size": 100, "hidden_size": 32,
     "num_hidden_layers": 2, "num_attention_heads": 4,
     "num_key_value_heads": 2, "intermediate_size": 64, "head_dim": 16,
     "attention_bias": False, "max_position_embeddings": 4096},
    {"model_type": "llama", "hidden_size": 32},           # missing keys
], ids=["llama", "qwen2", "qwen3", "broken"])
def test_from_hf_config_equal(tmp_path, raw):
    (tmp_path / "config.json").write_text(json.dumps(raw))
    j = J.DecoderConfig.from_hf_config(tmp_path)
    t = T.DecoderConfig.from_hf_config(tmp_path)
    assert (j is None) == (t is None)
    if j is not None:
        assert _fields(j) == _fields(t)
    assert T.DecoderConfig.from_hf_config(tmp_path / "absent") is None


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_params_bit_equal(family):
    jc, tc = _configs(family)
    want = J.init_params(jc, "bits", host=True)
    got = T.init_params(tc, "bits")
    assert set(want) == set(got)
    assert set(want["layers"]) == set(got["layers"])
    for k in ("tok_emb", "final_norm", "lm_head"):
        assert np.array_equal(want[k], got[k])
    for k, v in want["layers"].items():
        assert got["layers"][k].dtype == v.dtype
        assert np.array_equal(v, got["layers"][k]), k


def test_params_placement_dtypes():
    _jc, tc, tree, _ = _trees("qwen2")
    p = T.params_from_numpy(tree, tc, "cpu")
    assert p["tok_emb"].dtype == torch.float32
    assert p["lm_head"].dtype == torch.bfloat16
    assert p["layers"]["q_w"].dtype == torch.bfloat16
    assert p["layers"]["q_b"].dtype == torch.float32
    assert p["layers"]["attn_norm"].dtype == torch.float32
    # The reference casts to bf16 at every use: the stored values are it.
    want = torch.from_numpy(tree["layers"]["q_w"]).bfloat16()
    assert torch.equal(p["layers"]["q_w"], want)


def _forward_both(jc, tc, jp, tp, ids, pos, mask, jcache, tcache, offset):
    lj, cj = J.forward(jp, jnp.asarray(ids), jnp.asarray(pos), jcache,
                       jnp.int32(offset), jc, attn_mask=jnp.asarray(mask))
    lt, ct = T.forward(tp, torch.as_tensor(ids).long(),
                       torch.as_tensor(pos).long(), tcache, offset, tc,
                       attn_mask=torch.as_tensor(mask))
    return np.asarray(lj), cj, lt.numpy(), ct


def _close_cache(got, want, mode):
    """bf16 caches within one bf16 step; in W8A8 a flipped activation
    level moves its K/V rows as it moves the logits."""
    np.testing.assert_allclose(
        got.float().numpy(), _jcache(want), rtol=CACHE_RTOL,
        atol=ATOL_W8A8 if mode == "w8a8" else ATOL)


@pytest.mark.parametrize("mode", ["f32", "bf16", "w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_step_match(family, mode):
    """Prefill over a left-padded batch, then one cached decode step:
    logits within ATOL (f32 compute, as the transformers differentials
    run) or ATOL_ROUNDED, and both caches, against the JAX forward."""
    if mode == "f32":
        jc, tc = _configs(family, compute_dtype=jnp.float32)
        tc = dataclasses.replace(tc, compute_dtype=torch.float32)
        tree = T.init_params(tc, "diff")
        jp = jax.tree.map(jnp.asarray, tree)
    else:
        jc, tc, tree, jp = _trees(family)
    atol = {"f32": ATOL, "bf16": ATOL_ROUNDED, "w8a8": ATOL_W8A8}[mode]
    if mode == "w8a8":
        jp = J.quantize_decoder_params(jp, jc)
        tp = T.params_from_numpy(T.quantize_decoder_params_host(tree, tc),
                                 tc, "cpu")
    else:
        tp = T.params_from_numpy(tree, tc, "cpu")
    S = 24
    ids, lens = _prompts(seed=3, B=3, P=10, lens=(10, 6, 1))
    B, P = ids.shape
    pad = P - lens
    slot = np.arange(P)[None, :]
    pos = slot - pad[:, None]
    key = np.arange(S)[None, None, :]
    ok = (key >= pad[:, None, None]) & (key <= slot[:, :, None]) & (
        pos[:, :, None] >= 0)
    mask = np.where(ok, 0.0, NEG).astype(np.float32)
    lj, cj, lt, ct = _forward_both(
        jc, tc, jp, tp, ids, np.maximum(pos, 0), mask,
        J.empty_cache(jc, B, S), T.empty_cache(tc, B, S, device="cpu"), 0)
    # The left-pad query rows mask every key: they softmax to uniform.
    assert np.isfinite(lt).all()
    np.testing.assert_allclose(lt, lj, rtol=0, atol=atol)
    for a, b in zip(cj, ct):
        _close_cache(b, a, mode)
    tok = lj[:, -1].argmax(-1).astype(np.int32)[:, None]
    step_mask = np.where((key >= pad[:, None, None]) & (key <= P), 0.0,
                         NEG).astype(np.float32)
    lj2, cj2, lt2, ct2 = _forward_both(
        jc, tc, jp, tp, tok, (P - pad)[:, None], step_mask, cj, ct, P)
    np.testing.assert_allclose(lt2, lj2, rtol=0, atol=atol)
    for a, b in zip(cj2, ct2):
        _close_cache(b, a, mode)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_generate_ids_equal(family, quant):
    jc, tc, tree, jp = _trees(family)
    if quant:
        jp = J.quantize_decoder_params(jp, jc)
        tp = T.params_from_numpy(T.quantize_decoder_params_host(tree, tc),
                                 tc, "cpu")
    else:
        tp = T.params_from_numpy(tree, tc, "cpu")
    ids, lens = _prompts()
    eos = [2, 9999]
    want = np.asarray(J.make_generate_fn(jc, 64, 10)(
        jp, jnp.asarray(ids), jnp.asarray(lens), 0, 0.0, 0.95,
        jnp.asarray(eos, jnp.int32)))
    got = T.make_generate_fn(tc, 64, 10)(tp, ids, lens, 0, 0.0, 0.95, eos)
    assert got.shape == (4, 10)
    assert np.array_equal(got.numpy(), want)


def test_left_padding_invariance_and_equal_to_jax():
    """tests/test_generation.py's left-padding case: the same prompt with
    2 or 6 pad slots decodes the same, in both packages."""
    jc, tc, tree, jp = _trees("llama", "t")
    tp = T.params_from_numpy(tree, tc, "cpu")
    short = np.asarray([[0, 0, 9, 8, 7, 6]], np.int32)
    longpad = np.asarray([[0, 0, 0, 0, 0, 0, 9, 8, 7, 6]], np.int32)
    lens = np.asarray([4], np.int32)
    gen_t = T.make_generate_fn(tc, 64, 5)
    a = gen_t(tp, short, lens, 0, 0.0, 0.95, 2).numpy()
    b = gen_t(tp, longpad, lens, 0, 0.0, 0.95, 2).numpy()
    want = np.asarray(J.make_generate_fn(jc, 64, 5)(
        jp, jnp.asarray(short), jnp.asarray(lens), 0, 0.0, 0.95, 2))
    assert np.array_equal(a, b)
    assert np.array_equal(a, want)


def test_stops_on_any_declared_eos():
    """tests/test_generation.py:215: declaring the first emitted token as
    one of several eos ids stops the row there; the rest is padding."""
    jc, tc, tree, jp = _trees("llama", "eos-fixture")
    tp = T.params_from_numpy(tree, tc, "cpu")
    gen_t = T.make_generate_fn(tc, 32, 8)
    gen_j = J.make_generate_fn(jc, 32, 8)
    ids = np.asarray([[5, 6, 7, 8]], np.int32)
    lens = np.asarray([4], np.int32)
    free = gen_t(tp, ids, lens, 0, 0.0, 0.95, [9999]).numpy()[0]
    first = int(free[0])
    stop = gen_t(tp, ids, lens, 0, 0.0, 0.95, [first, 9999]).numpy()[0]
    want = np.asarray(gen_j(jp, jnp.asarray(ids), jnp.asarray(lens), 0,
                            0.0, 0.95, jnp.asarray([first, 9999],
                                                   jnp.int32)))[0]
    assert stop[0] == first and (stop[1:] == first).all(), stop
    assert np.array_equal(stop, want)


def test_sampling_properties():
    _jc, tc, tree, _ = _trees("llama")
    tp = T.params_from_numpy(tree, tc, "cpu")
    gen = T.make_generate_fn(tc, 64, 12)
    ids, lens = _prompts()
    a = gen(tp, ids, lens, 7, 1.0, 0.9, [9999])
    b = gen(tp, ids, lens, 7, 1.0, 0.9, [9999])
    c = gen(tp, ids, lens, 8, 1.0, 0.9, [9999])
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    greedy = gen(tp, ids, lens, 7, 0.0, 0.9, [9999])
    # temperature <= 0 is greedy whatever the seed; a nucleus of one
    # token (top_p -> 0) is the argmax too.
    assert torch.equal(gen(tp, ids, lens, 3, -1.0, 0.9, [9999]), greedy)
    assert torch.equal(gen(tp, ids, lens, 3, 1.0, 1e-9, [9999]), greedy)
    assert not torch.equal(a, greedy)


@pytest.mark.parametrize("top_p", [0.3, 0.9, 1.0])
def test_sample_stays_in_nucleus(top_p):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(
        (rng.standard_normal((6, 300)) * 3).astype(np.float32))
    temp = 0.7
    scaled = logits / temp
    probs = torch.softmax(scaled, -1)
    order = probs.argsort(-1, descending=True)
    cum = probs.gather(-1, order).cumsum(-1)
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        tok = T._sample(logits, g, temp, top_p)
        for r in range(6):
            rank = int((order[r] == tok[r]).nonzero())
            # The nucleus: the smallest prefix of the sorted tokens whose
            # mass reaches top_p.
            assert rank == 0 or float(cum[r, rank - 1]) < top_p
            seen.add((r, int(tok[r])))
    assert len(seen) > 6        # it samples, not argmax


@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantized_trees_bit_equal(family):
    jc, tc, tree, jp = _trees(family)
    want = J.quantize_decoder_params(jp, jc)
    host = T.quantize_decoder_params_host(tree, tc)
    dev = T.quantize_decoder_params(
        {**{k: torch.from_numpy(v) for k, v in tree.items()
            if k != "layers"},
         "layers": {k: torch.from_numpy(v)
                    for k, v in tree["layers"].items()}}, tc)
    for got in (host, dev):
        for path, w in (("tok_emb", want["tok_emb"]),
                        ("lm_head", want["lm_head"])):
            g = got[path]
            assert np.array_equal(np.asarray(g.q), np.asarray(w.q)), path
            assert np.array_equal(np.asarray(g.scale), np.asarray(w.scale))
        for k in T._QUANT_LAYER_KEYS:
            g, w = got["layers"][k], want["layers"][k]
            assert np.asarray(g.q).dtype == np.int8
            assert np.array_equal(np.asarray(g.q), np.asarray(w.q)), k
            assert np.array_equal(np.asarray(g.scale), np.asarray(w.scale))
    placed = T.params_from_numpy(host, tc, "cpu")
    assert T.quantized_param_bytes(placed) == J.quantized_param_bytes(want)


def test_w8a8_logits_close_to_bf16():
    """The JAX package's own bars at tiny_test (tests/test_quant_decoder.py):
    row cosine of W8A8 against bf16 logits >= 0.999 (B 2, T 8), and
    teacher-forced argmax agreement >= 0.90 (B 4, T 30)."""
    _jc, tc, tree, _ = _trees("llama")
    bf = T.params_from_numpy(tree, tc, "cpu")
    q8 = T.params_from_numpy(T.quantize_decoder_params_host(tree, tc),
                             tc, "cpu")
    rng = np.random.default_rng(0)
    for (B, n), check in (((2, 8), "cos"), ((4, 30), "argmax")):
        ids = torch.from_numpy(rng.integers(4, tc.vocab_size, (B, n)))
        pos = torch.arange(n).expand(B, n)
        mask = torch.where(torch.arange(n)[None, None] <= pos[:, :, None],
                           0.0, NEG)
        a, _ = T.forward(bf, ids, pos, T.empty_cache(tc, B, n, device="cpu"),
                         0, tc, mask)
        b, _ = T.forward(q8, ids, pos, T.empty_cache(tc, B, n, device="cpu"),
                         0, tc, mask)
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        if check == "cos":
            cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
            assert float(cos.min()) >= 0.999
        else:
            agree = (a.argmax(-1) == b.argmax(-1)).float().mean()
            assert float(agree) >= 0.90


def test_forward_guards():
    _jc, tc, tree, _ = _trees("llama")
    tp = T.params_from_numpy(tree, tc, "cpu")
    cache = T.empty_cache(tc, 1, 8, device="cpu")
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(TypeError, match="attn_mask"):
        T.forward(tp, ids, ids, cache, 0, tc)
    with pytest.raises(ValueError, match="outside"):
        T.forward(tp, ids, ids, cache, 6, tc, torch.zeros(1, 4, 8))
    with pytest.raises(ValueError, match="exceed"):
        T.make_generate_fn(tc, 8, 6)(tp, np.ones((1, 4)), [4], 0, 0.0,
                                     0.9, 2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_last_only_head_equals_the_last_slice(family):
    """The prefill's head on the last position alone (``last_only``, what
    ``make_generate_fn`` runs) gives the logits of the full [B, T, V]
    forward's last position, and the same cache. The head's rows are the
    same dot products; only the product's row count differs, so the f32
    sums may differ in the last bit (ATOL)."""
    _jc, tc, tree, _ = _trees(family)
    tp = T.params_from_numpy(tree, tc, "cpu")
    S = 24
    ids, lens = _prompts(seed=5, B=3, P=10, lens=(10, 6, 1))
    pad = 10 - lens
    slot = np.arange(10)[None, :]
    pos = np.maximum(slot - pad[:, None], 0)
    key = np.arange(S)[None, None, :]
    ok = (key >= pad[:, None, None]) & (key <= slot[:, :, None])
    mask = torch.as_tensor(np.where(ok, 0.0, NEG).astype(np.float32))
    args = (torch.as_tensor(ids, dtype=torch.long),
            torch.as_tensor(pos, dtype=torch.long))
    full, c1 = T.forward(tp, *args, T.empty_cache(tc, 3, S, device="cpu"),
                         0, tc, attn_mask=mask)
    last, c2 = T.forward(tp, *args, T.empty_cache(tc, 3, S, device="cpu"),
                         0, tc, attn_mask=mask, last_only=True)
    assert last.shape == (3, 1, tc.vocab_size)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=0, atol=ATOL)
    for a, b in zip(c1, c2):
        assert torch.equal(a, b)
