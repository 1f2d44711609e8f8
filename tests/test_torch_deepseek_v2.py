"""The port's DeepSeek-V2 decoder (MLA over a latent cache, sparse experts,
YaRN RoPE; ``models/{decoder,mla,moe,hf_state}.py``) against the plain
reference ``models/deepseek_v2_ref.py``, on the CPU, at a tiny shape of
the same kind: 1 dense + 3 MoE layers, 8 experts top-3, 2 shared,
kv_lora 32, rope 16, nope 32, v 32, vocabulary 512, YaRN on.

Weights are seeded random draws by HF name (``hf_state.SeededHFState``);
the reference reads the same tensors. Tolerances:

- ``ATOL_F32``: the program in f32 (``compute_dtype`` float32) computes
  the reference's sums in another order and form (absorbed W_kv_b,
  grouped expert products): ~1e-7 measured, 1e-5 allowed.
- ``REL_BF16``: in bf16 every product's operands and the latent cache
  are rounded to 8 significant bits (2^-9 relative a rounding), over
  four layers of several products each: the largest |Δlogit| measured
  is 0.4 % of the reference's logit RMS; 3 % allowed, while rounding
  the weights to float8 (the benchmark's control) gives ~20 %.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from classmate_rag_tpu_torch.generation import runner as TR
from classmate_rag_tpu_torch.models import deepseek_v2_ref as REF
from classmate_rag_tpu_torch.models import decoder as D
from classmate_rag_tpu_torch.models import hf_state as HS
from classmate_rag_tpu_torch.models import mla as MLA
from classmate_rag_tpu_torch.models import moe as MOE
from classmate_rag_tpu_torch.utils.metrics import metrics

ATOL_F32 = 1e-5
REL_BF16 = 3e-2

TINY = {
    "model_type": "deepseek_v2", "vocab_size": 512, "hidden_size": 64,
    "num_hidden_layers": 4, "num_attention_heads": 4,
    "num_key_value_heads": 4, "intermediate_size": 128,
    "max_position_embeddings": 2048, "rope_theta": 10000,
    "rms_norm_eps": 1e-6, "kv_lora_rank": 32, "q_lora_rank": None,
    "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
    "n_routed_experts": 8, "num_experts_per_tok": 3,
    "moe_intermediate_size": 32, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "moe_layer_freq": 1,
    "routed_scaling_factor": 1.0, "norm_topk_prob": False,
    "topk_method": "greedy", "scoring_func": "softmax",
    # original 64 positions: the ramp lies inside the 8 frequencies.
    "rope_scaling": {"type": "yarn", "factor": 40,
                     "original_max_position_embeddings": 64,
                     "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                     "mscale_all_dim": 0.707},
}


def _config(dtype=torch.float32, **raw):
    return dataclasses.replace(D.DecoderConfig.from_hf_dict({**TINY, **raw}),
                               compute_dtype=dtype)


def _state(cfg, key="ds"):
    st = HS.SeededHFState(cfg, key, "cpu")
    return {n: st.pop(n) for n in list(st.keys())}


def _program(cfg, state):
    return HS.params_from_hf_state(dict(state), cfg, "cpu")


def _ref_logits(state, ids, raw=None):
    return REF.forward(state.__getitem__, REF.config({**TINY, **(raw or {})}),
                       torch.as_tensor(ids))


def _mask(T, S, offset=0):
    key = torch.arange(S)[None, None, :]
    q = offset + torch.arange(T)[None, :, None]
    return torch.where(key <= q, 0.0, D.NEG_INF)


def _rel(got, want):
    return float((got - want).abs().max() / want.pow(2).mean().sqrt())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_full_forward_matches_reference(dtype):
    cfg = _config(dtype)
    state = _state(cfg)
    ids = torch.randint(0, 512, (1, 21), generator=torch.Generator()
                        .manual_seed(0))
    want = _ref_logits(state, ids[0])
    cache = D.empty_cache(cfg, 1, 32, device="cpu")
    got, _ = D.forward(_program(cfg, state), ids, torch.arange(21)[None],
                       cache, 0, cfg, attn_mask=_mask(21, 32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL_F32)
    else:
        assert _rel(got[0], want) < REL_BF16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_then_absorbed_decode_matches_full_forward(dtype):
    """Prefill 12 positions (decompressed K/V), then one position a step
    through the latent cache (absorbed W_kv_b), against the reference's
    full forward at every position."""
    cfg = _config(dtype)
    state = _state(cfg)
    params = _program(cfg, state)
    ids = torch.randint(0, 512, (1, 20), generator=torch.Generator()
                        .manual_seed(1))
    want = _ref_logits(state, ids[0])
    cache = D.empty_cache(cfg, 1, 24, device="cpu")
    assert cache.shape == (4, 1, 24, 32 + 16) and cache.dtype == dtype
    got, cache = D.forward(params, ids[:, :12], torch.arange(12)[None],
                           cache, 0, cfg, attn_mask=_mask(12, 24),
                           last_only=True)
    rows = [got[0, -1]]
    for t in range(12, 20):
        got, cache = D.forward(params, ids[:, t:t + 1], torch.tensor([[t]]),
                               cache, t, cfg, attn_mask=_mask(1, 24, t))
        rows.append(got[0, -1])
    got = torch.stack(rows)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want[11:].numpy(), rtol=0,
                                   atol=ATOL_F32)
    else:
        assert _rel(got, want[11:]) < REL_BF16


def _generate(cfg, params, prompts, max_new=6, width=16):
    gen = D.make_generate_fn(cfg, width + max_new, max_new)
    B = len(prompts)
    arr = np.zeros((B, width), np.int64)
    lens = np.array([len(p) for p in prompts])
    for i, p in enumerate(prompts):
        arr[i, width - len(p):] = p
    seen = []
    toks = gen(params, arr, lens, 0, 0.0, 1.0, [511],
               on_logits=lambda i, lg: seen.append(lg.clone()))
    return toks, torch.stack(seen, dim=1)                 # [B, max_new, V]


def test_generate_logits_match_reference_at_every_step():
    """make_generate_fn (left-padded prefill, greedy decode through the
    latent cache): each step's logits against the reference's full
    forward over the prompt and the tokens taken."""
    cfg = _config()
    state = _state(cfg)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, 511, (n,), generator=g).tolist()
               for n in (16, 9, 3)]
    toks, logits = _generate(cfg, _program(cfg, state), prompts)
    for r, p in enumerate(prompts):
        seq = p + toks[r, :-1].tolist()
        want = _ref_logits(state, seq)[len(p) - 1:]
        np.testing.assert_allclose(logits[r].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL_F32)
        assert toks[r].tolist() == logits[r].argmax(-1).tolist()


def test_left_padded_rows_equal_unpadded_single_rows():
    cfg = _config()
    params = _program(cfg, _state(cfg))
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 511, (n,), generator=g).tolist()
               for n in (5, 16, 11)]
    toks, logits = _generate(cfg, params, prompts)
    for r, p in enumerate(prompts):
        t1, l1 = _generate(cfg, params, [p], width=len(p))
        assert toks[r].tolist() == t1[0].tolist()
        np.testing.assert_allclose(logits[r].numpy(), l1[0].numpy(),
                                   rtol=0, atol=ATOL_F32)


def _closed_form_inv_freq(dim, base, factor, orig, fast, slow):
    def corr(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    low, high = max(math.floor(corr(fast)), 0), min(math.ceil(corr(slow)),
                                                    dim - 1)
    out = []
    for j in range(dim // 2):
        extra = base ** (-2 * j / dim)
        ramp = min(max((j - low) / (high - low), 0.0), 1.0)
        out.append(extra / factor * ramp + extra * (1 - ramp))
    return np.array(out)


def test_yarn_tables_and_softmax_scale_closed_form():
    cfg = D.DecoderConfig.deepseek_v2_lite()
    m = cfg.mla
    inv = MLA.rope_inv_freq(64, 10000.0, m.yarn).numpy()
    # DeepSeek-V2-Lite: the ramp runs from dim pair 10 to 23.
    np.testing.assert_allclose(
        inv, _closed_form_inv_freq(64, 10000.0, 40, 4096, 32, 1), rtol=1e-6)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert MLA.softmax_scale(m) == pytest.approx(
        192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert MLA.softmax_scale(m) == pytest.approx(0.1147, abs=1e-4)
    # cos/sin against the reference's tables, with an mscale ratio != 1.
    raw = {"rope_scaling": dict(TINY["rope_scaling"], mscale=1.0)}
    c2 = _config(**raw)
    pos = torch.arange(40)[None]
    cos, sin = MLA.rope_tables(pos, c2.mla, c2.rope_theta)
    rc, rs = REF.rope_cos_sin(REF.config({**TINY, **raw}), pos[0])
    np.testing.assert_allclose(cos[0, :, 0].numpy(), rc.numpy(), atol=1e-6)
    np.testing.assert_allclose(sin[0, :, 0, 8:].numpy(), rs[:, 8:].numpy(),
                               atol=1e-6)
    # YaRN moves the frequencies past the ramp's start.
    assert not np.allclose(inv, MLA.rope_inv_freq(64, 10000.0, None).numpy())


def test_topk_weights_are_not_renormalised():
    cfg = _config()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(10, 64, generator=g)
    w = 0.1 * torch.randn(64, 8, generator=g)
    scores, experts = MOE.route(x, w, 3)
    probs = torch.softmax(x @ w, dim=-1)
    np.testing.assert_allclose(scores.numpy(), probs.gather(
        1, experts).numpy(), rtol=1e-6)
    assert (scores.sum(-1) < 0.9).all()
    # The whole MoE block against the experts one by one, each weighted
    # by its raw score; a router that sends every token to experts 5, 6,
    # 7 leaves five groups of the grouped products empty.
    state = _state(cfg)
    lp = _program(cfg, state)["layers"][1]
    h = torch.randn(1, 10, 64, generator=g)
    for skewed in (False, True):
        if skewed:
            # Hidden rows near the all-ones direction, a router that
            # scores it +-64: experts 5, 6, 7 take every token.
            h = 1.0 + 0.01 * torch.randn(1, 10, 64, generator=g)
            sign = torch.tensor([-1.0] * 5 + [1.0] * 3)
            lp = dict(lp, router_w=sign.expand(64, 8).contiguous())
        got = MOE.moe_ffn(lp, h, cfg, 0)
        normed = D._rms_norm(h, lp["ffn_norm"], cfg.norm_eps)[0]
        s, e = MOE.route(normed, lp["router_w"], 3)
        want = torch.zeros(10, 64)
        for t in range(10):
            for j in range(3):
                k = int(e[t, j])
                gu = lp["experts_gate_up"][k]
                a = torch.nn.functional.silu(normed[t] @ gu[:32].T) * (
                    normed[t] @ gu[32:].T)
                want[t] += s[t, j] * (a @ lp["experts_down"][k].T)
        want += MOE.swiglu(normed, lp["shared_gate_up_w"],
                           lp["shared_down_w"], torch.float32)
        np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=1e-5)
    assert set(e.flatten().tolist()) <= {5, 6, 7}


def test_hf_checkpoint_converts_through_the_one_path(tmp_path):
    """A synthetic pytorch_model.bin with the public checkpoint's names and
    shapes: config.json → the DeepSeek config, load_params_from_hf → the
    tree, the runner loads it; logits equal the reference's."""
    cfg = _config(torch.bfloat16)
    state = _state(cfg, key="ckpt")
    torch.save({k: v.clone() for k, v in state.items()},
               tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(
        {**TINY, "eos_token_id": 100}))
    got_cfg = D.DecoderConfig.from_hf_config(tmp_path)
    assert got_cfg == D.DecoderConfig.from_hf_dict(TINY)
    assert got_cfg.mla.kv_lora_rank == 32 and got_cfg.moe.n_experts == 8
    c32 = dataclasses.replace(got_cfg, compute_dtype=torch.float32)
    params = D.load_params_from_hf(str(tmp_path), c32, device="cpu")
    ids = torch.arange(3, 17)[None]
    got, _ = D.forward(params, ids, torch.arange(14)[None],
                       D.empty_cache(c32, 1, 16, device="cpu"), 0, c32,
                       attn_mask=_mask(14, 16))
    np.testing.assert_allclose(got[0].numpy(),
                               _ref_logits(state, ids[0]).numpy(), rtol=0,
                               atol=ATOL_F32)
    r = TR.DecodeRunner(model_dir=str(tmp_path), max_seq=48,
                        max_new_tokens=4, device="cpu")
    assert r.has_pretrained_weights and r.eos_ids == [100]
    assert len(r.generate_ids([5, 6, 7], temperature=0.0)) <= 4
    # A checkpoint of another shape is not loaded.
    bad = D.DecoderConfig.from_hf_dict({**TINY, "v_head_dim": 16})
    assert D.load_params_from_hf(str(tmp_path), bad, device="cpu") is None


def test_from_hf_config_refuses_unsupported_variants():
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        D.DecoderConfig.from_hf_dict({**TINY, "q_lora_rank": 1536})
    with pytest.raises(NotImplementedError, match="greedy"):
        D.DecoderConfig.from_hf_dict(
            {**TINY, "topk_method": "group_limited_greedy"})
    assert D.DecoderConfig.from_hf_dict(
        {k: v for k, v in TINY.items() if k != "kv_lora_rank"}) is None
    with pytest.raises(ValueError, match="device"):
        D.init_params(_config(), "x")


def test_runner_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    for var in ("TPU_DECODE_INT8", "TPU_DECODE_TP"):
        monkeypatch.delenv(var, raising=False)
    cfg = _config(torch.bfloat16)
    kw = dict(config=cfg, max_seq=32, max_new_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        TR.DecodeRunner(quantize=True, **kw)
    monkeypatch.setenv("TPU_DECODE_INT8", "1")
    with pytest.raises(ValueError, match="int8"):
        TR.DecodeRunner(**kw)
    monkeypatch.delenv("TPU_DECODE_INT8")
    from classmate_rag_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(M, "local_devices",
                        lambda *a, **k: [torch.device("cpu")] * 4)
    monkeypatch.setenv("TPU_DECODE_TP", "1")
    with pytest.raises(ValueError, match="TPU_DECODE_TP"):
        TR.DecodeRunner(**kw)
    monkeypatch.delenv("TPU_DECODE_TP")
    with pytest.raises(ValueError, match="mesh"):
        TR.DecodeRunner(mesh=M.DeviceMesh([[torch.device("cpu")] * 2]), **kw)
    from classmate_rag_tpu_torch.models import gguf as TG

    path = tmp_path / "ds.gguf"
    TG.write_gguf(path, {"general.architecture": "deepseek2",
                         "deepseek2.block_count": 4}, {})
    with pytest.raises(ValueError, match="deepseek2"):
        TR.DecodeRunner(model_dir=str(path), device="cpu")
    with pytest.raises(ValueError, match="MLA/MoE"):
        TR.DecodeRunner(config=D.DecoderConfig.tiny_test(),
                        hf_state={}, device="cpu")
    # With one card, TPU_DECODE_TP asks for nothing: the runner builds.
    monkeypatch.setattr(M, "local_devices",
                        lambda *a, **k: [torch.device("cpu")])
    monkeypatch.setenv("TPU_DECODE_TP", "1")
    assert TR.DecodeRunner(**kw).config.latent


def test_tracing_spans_and_expert_tallies():
    cfg = _config(torch.bfloat16)
    r = TR.DecodeRunner(config=cfg, hf_state=HS.SeededHFState(cfg, "t",
                                                              "cpu"),
                        max_seq=40, max_new_tokens=5, device="cpu")
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8, 9, 10, 11]]
    plain = r.generate_ids_batch(prompts, seed=3, temperature=0.2)
    tallies = {}
    with metrics.tracing(tallies=tallies) as spans:
        traced = r.generate_ids_batch(prompts, seed=3, temperature=0.2)
    assert traced == plain
    names = [s.name for s in spans]
    assert names.count("decode.prefill") == 1
    assert names.count("decode.step") == 5
    assert names.count("mla.prefill") == 4 and names.count("mla.decode") == 16
    assert names.count("moe.experts") == 3 * 5
    width = r.max_seq - r.max_new                           # 35
    pairs = [s.counts["routed_pairs"] for s in spans
             if s.name == "moe.experts"]
    assert pairs == [2 * width * 3] * 3 + [2 * 3] * 12
    t = tallies["moe.expert_tokens"]
    assert t.shape == (3, 8) and int(t.sum()) == sum(pairs)
    # On the CPU no span carries CUDA events.
    assert not any("cuda_events" in s.counts for s in spans)


def test_ask_pipeline_answers_through_the_runner(tmp_path, monkeypatch):
    """DecodeRunner + chat_batch through the ask pipeline: the batch ask
    makes one batched decode and answers every question."""
    import test_torch_pipeline as P
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.ask import (
        ask_question,
        ask_question_batch,
    )
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    monkeypatch.setattr(P.t_ingest, "datetime", P._FixedNow)
    docs = tmp_path / "docs"
    docs.mkdir()
    for name, text in (("calc.md", P.CALC), ("pasta.txt", P.PASTA)):
        (docs / name).write_text(text)
    P._env(monkeypatch, tmp_path / "t", LLM_TEMPERATURE="0",
           LLM_MAX_TOKENS="6")
    rt = get_runtime(reload=True, device="cpu")
    for name in ("calc.md", "pasta.txt"):
        P.t_ingest.ingest_file(path=docs / name,
                               doc_meta=normalize_cli_metadata(), runtime=rt)
    cfg = _config(torch.bfloat16)
    runner = TR.DecodeRunner(config=cfg,
                             hf_state=HS.SeededHFState(cfg, "ask", "cpu"),
                             max_seq=640, max_new_tokens=6, device="cpu")
    calls = []
    real = runner.generate_ids_batch

    def counting(prompts, **kw):
        calls.append(len(prompts))
        return real(prompts, **kw)

    monkeypatch.setattr(runner, "generate_ids_batch", counting)
    rt._runner = runner
    one = ask_question(question="what is a derivative",
                       filters=normalize_cli_metadata(), top_k=3, runtime=rt)
    assert one.answer and calls[0] == 1
    many = ask_question_batch(
        questions=["what is a derivative", "how long to boil pasta"],
        filters=normalize_cli_metadata(), top_k=3, runtime=rt)
    assert [a.answer for a in many] and all(a.answer for a in many)
    assert 2 in calls[1:]
