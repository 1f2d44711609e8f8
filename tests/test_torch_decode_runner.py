"""The port's decode runner (``DecodeRunner``, ``get_runner``) and the ask
path with the decoder, against the JAX package's ``TPUDecodeRunner``.

Checkpoints are built on disk from a seeded numpy tree: an HF directory
(config.json, model.safetensors, tokenizer.json, as
tests/test_hf_checkpoint_roundtrip.py builds one) for each of the three
families, and a GGUF with an embedded tokenizer (as tests/test_gguf.py
builds one). At temperature 0 both runners decode greedily, so their
strings must be EQUAL; the port runs on the CPU (``device="cpu"``).
"""

import json
import struct

import numpy as np
import pytest
import torch

from classmate_rag_tpu.generation.runner import TPUDecodeRunner
from classmate_rag_tpu.models import gguf as JG
from classmate_rag_tpu_torch.generation import runner as TR
from classmate_rag_tpu_torch.models import decoder as T
from classmate_rag_tpu_torch.models import gguf as TG

WORDS = ["what", "is", "a", "derivative", "the", "rate", "of", "change",
         "pasta", "boil", "water", "minutes", "[1]", "answer", "context"]
FAMILIES = {
    "llama": {},
    "qwen2": dict(qkv_bias=True),
    "qwen3": dict(qk_norm=True, head_dim_override=24),
}
CONVS = [
    [{"role": "user", "content": "what is a derivative"}],
    [{"role": "system", "content": "answer briefly"},
     {"role": "user", "content": "the rate of change"}],
    [{"role": "user", "content": "boil the pasta water"}],
]
RUN = dict(max_new_tokens=6, max_seq=64)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for var in ("TPU_DECODE_INT8", "TPU_DECODE_TP", "TPU_DECODER_MODEL_DIR",
                "TPU_DECODE_MAX_SEQ", "LLAMA_CPP_LIB"):
        monkeypatch.delenv(var, raising=False)
    TR._FAILED_GGUF_RESOLVES.clear()
    yield
    TR._FAILED_GGUF_RESOLVES.clear()
    from classmate_rag_tpu.config import load_config as jload
    from classmate_rag_tpu_torch.config import load_config as tload

    jload(reload=True)
    tload(reload=True)


def write_hf_checkpoint(path, family="llama", seed_key="hf", eos=2):
    """An HF checkpoint of the tiny_test shape in ``family``."""
    from safetensors.numpy import save_file
    from tokenizers import Tokenizer, models, pre_tokenizers

    cfg = T.DecoderConfig(**{**_tiny_fields(), **FAMILIES[family]})
    tree = T.init_params(cfg, seed_key)
    lp = tree["layers"]

    def c(x):
        return np.ascontiguousarray(x, np.float32)

    sd = {"model.embed_tokens.weight": c(tree["tok_emb"]),
          "model.norm.weight": c(tree["final_norm"]),
          "lm_head.weight": c(tree["lm_head"].T)}
    names = {"q_w": "self_attn.q_proj.weight",
             "k_w": "self_attn.k_proj.weight",
             "v_w": "self_attn.v_proj.weight",
             "o_w": "self_attn.o_proj.weight",
             "gate_w": "mlp.gate_proj.weight",
             "up_w": "mlp.up_proj.weight",
             "down_w": "mlp.down_proj.weight",
             "attn_norm": "input_layernorm.weight",
             "ffn_norm": "post_attention_layernorm.weight",
             "q_b": "self_attn.q_proj.bias", "k_b": "self_attn.k_proj.bias",
             "v_b": "self_attn.v_proj.bias",
             "q_norm": "self_attn.q_norm.weight",
             "k_norm": "self_attn.k_norm.weight"}
    for i in range(cfg.layers):
        for key, arr in lp.items():
            w = arr[i].T if key.endswith("_w") else arr[i]
            sd[f"model.layers.{i}.{names[key]}"] = c(w)
    path.mkdir(parents=True, exist_ok=True)
    save_file(sd, str(path / "model.safetensors"))
    raw = {"model_type": family, "vocab_size": cfg.vocab_size,
           "hidden_size": cfg.hidden, "num_hidden_layers": cfg.layers,
           "num_attention_heads": cfg.heads,
           "num_key_value_heads": cfg.kv_heads,
           "intermediate_size": cfg.ffn,
           "max_position_embeddings": cfg.max_seq,
           "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
           "eos_token_id": eos}
    if cfg.head_dim_override:
        raw["head_dim"] = cfg.head_dim_override
    (path / "config.json").write_text(json.dumps(raw))
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    while len(vocab) < cfg.vocab_size:     # every id decodes to a word
        vocab[f"w{len(vocab)}"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path / "tokenizer.json"))
    return cfg, tree


def _tiny_fields():
    c = T.DecoderConfig.tiny_test()
    return {f: getattr(c, f) for f in (
        "vocab_size", "hidden", "layers", "heads", "kv_heads", "ffn",
        "max_seq")}


def _tiny_tokens(vocab_size):
    toks = ["<unk>", "<s>", "</s>"]
    toks += [f"<0x{b:02X}>" for b in range(256)]
    toks += ["▁what", "▁is", "▁a", "▁derivative", "▁the", "▁rate", "▁of",
             "▁change", "▁pasta", "▁boil", "▁water", "ing", "er"]
    toks += [f"<pad{i}>" for i in range(vocab_size - len(toks))]
    return toks[:vocab_size]


def write_gguf_model(path, tokens=None, eos=2, seed_key="gguf-fixture"):
    cfg = T.DecoderConfig.tiny_test()
    tree = T.init_params(cfg, seed_key)
    tokens = tokens or _tiny_tokens(cfg.vocab_size)
    scores = [0.0] * 3 + [-10.0] * 256 + [-1.0] * 13 + [-25.0] * (
        cfg.vocab_size - 272)
    TG.export_decoder_to_gguf(
        path, tree, cfg, quant_type=TG.GGML_Q8_0,
        extra_metadata={
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": (TG.T_ARRAY, (TG.T_STRING, tokens)),
            "tokenizer.ggml.scores": (TG.T_ARRAY, (TG.T_FLOAT32, scores)),
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": eos,
            "tokenizer.ggml.unknown_token_id": 0,
        })
    return cfg, tree


def _both(model_dir, **kw):
    j = TPUDecodeRunner(model_dir=str(model_dir), **{**RUN, **kw})
    t = TR.DecodeRunner(model_dir=str(model_dir), device="cpu",
                        **{**RUN, **kw})
    return j, t


def _same_answers(j, t):
    assert [t.chat(c, temperature=0.0) for c in CONVS] == [
        j.chat(c, temperature=0.0) for c in CONVS]
    assert t.chat_batch(CONVS, temperature=0.0) == j.chat_batch(
        CONVS, temperature=0.0)
    assert t.chat_batch(CONVS, temperature=0.0) == [
        t.chat(c, temperature=0.0) for c in CONVS]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_directory_runner_matches(tmp_path, family):
    write_hf_checkpoint(tmp_path / family, family)
    j, t = _both(tmp_path / family)
    assert t.has_pretrained_weights and j.has_pretrained_weights
    assert (t.model_name, t.eos_ids, t.max_seq, t.max_new) == (
        j.model_name, j.eos_ids, j.max_seq, j.max_new)
    assert t.config.qkv_bias == (family == "qwen2")
    assert t.config.qk_norm == (family == "qwen3")
    _same_answers(j, t)
    ids = [[5, 6, 7], [8], [9, 10, 11, 12]]
    assert t.generate_ids_batch(ids) == j.generate_ids_batch(ids)


def test_gguf_runner_matches(tmp_path):
    path = tmp_path / "route-model.gguf"
    write_gguf_model(path)
    j, t = _both(path)
    assert t.has_pretrained_weights
    assert t.model_name == "route-model.gguf" == j.model_name
    assert t.eos_ids == [2] == j.eos_ids
    assert isinstance(t.tokenizer, TG.GGUFTokenizer)
    _same_answers(j, t)


def test_eos_lists(tmp_path):
    tokens = _tiny_tokens(512)
    tokens[-2], tokens[-1] = "<|end_of_text|>", "<|eot_id|>"
    path = tmp_path / "llama3ish.gguf"
    write_gguf_model(path, tokens=tokens, eos=510)
    j, t = _both(path)
    assert t.eos_ids == [510, 511] == j.eos_ids
    assert t.eos_id == 511
    write_hf_checkpoint(tmp_path / "hf", eos=[5, 7])
    j, t = _both(tmp_path / "hf")
    assert t.eos_ids == [5, 7] == j.eos_ids
    # Any declared id ends a row: the first emitted token as an eos id
    # leaves nothing.
    first = t.generate_ids_batch([[5, 6, 7]])[0][0]
    t.eos_ids = [first, 9999]
    assert t.generate_ids_batch([[5, 6, 7]]) == [[]]


def test_max_tokens_cap_and_window_clamp(tmp_path):
    t = TR.DecodeRunner(config=T.DecoderConfig.tiny_test(), max_seq=4096,
                        max_new_tokens=768, device="cpu")
    from classmate_rag_tpu.models.decoder import DecoderConfig

    j = TPUDecodeRunner(config=DecoderConfig.tiny_test(), max_seq=4096,
                        max_new_tokens=768)
    assert (t.max_seq, t.max_new) == (j.max_seq, j.max_new) == (128, 64)
    t = TR.DecodeRunner(config=T.DecoderConfig.tiny_test(), max_seq=64,
                        max_new_tokens=16, device="cpu")
    j = TPUDecodeRunner(config=DecoderConfig.tiny_test(), max_seq=64,
                        max_new_tokens=16)
    full = t.generate_ids_batch([[5, 6, 7]], temperature=0.0)
    capped = t.generate_ids_batch([[5, 6, 7]], temperature=0.0,
                                  max_tokens=3)
    assert len(capped[0]) <= 3 and capped[0] == full[0][:len(capped[0])]
    assert full == j.generate_ids_batch([[5, 6, 7]], temperature=0.0)
    assert capped == j.generate_ids_batch([[5, 6, 7]], temperature=0.0,
                                          max_tokens=3)


# W8A8 logits of the two packages differ by up to ~1e-2 where an int8
# activation lands one level apart (tests/test_torch_decoder.py), so a
# greedy step whose top two logits are closer than that may go either
# way (tests/test_quant_decoder.py documents the same against bf16).
NEAR_TIE = 2e-2


def _agree_until_near_tie(j, t, prompts):
    """The runners' greedy ids are equal, or equal up to a step where the
    JAX logits' top two are within NEAR_TIE and the port took the other."""
    from classmate_rag_tpu.models.decoder import empty_cache, forward
    import jax.numpy as jnp

    diverged = 0
    for ids, a, b in zip(prompts, j.generate_ids_batch(prompts),
                         t.generate_ids_batch(prompts)):
        if a == b:
            continue
        k = next(i for i in range(max(len(a), len(b)))
                 if a[i:i + 1] != b[i:i + 1])
        seq = list(ids) + a[:k]
        n = len(seq)
        pos = jnp.arange(n, dtype=jnp.int32)[None]
        mask = jnp.where(jnp.arange(n)[None, None] <= pos[:, :, None], 0.0,
                         jnp.finfo(jnp.float32).min)
        logits, _ = forward(j.params, jnp.asarray([seq], jnp.int32), pos,
                            empty_cache(j.config, 1, n), jnp.int32(0),
                            j.config, attn_mask=mask)
        last = np.asarray(logits)[0, -1]
        top = np.argsort(-last)[:2]
        assert last[top[0]] - last[top[1]] < NEAR_TIE, (k, a, b)
        assert (b[k:k + 1] or t.eos_ids[:1])[0] in list(top) + t.eos_ids
        diverged += 1
    return diverged


def test_int8_runner_matches(tmp_path, monkeypatch):
    write_hf_checkpoint(tmp_path / "hf", "qwen2")
    monkeypatch.setenv("TPU_DECODE_INT8", "1")
    j, t = _both(tmp_path / "hf")
    assert t.quantized and j.quantized
    assert isinstance(t.params["layers"]["q_w"], T.QTensor)
    assert t.params["layers"]["q_w"].q.dtype == torch.int8
    prompts = [t._encode_prompt(c) for c in CONVS]
    assert prompts == [j._encode_prompt(c) for c in CONVS]
    assert _agree_until_near_tie(j, t, prompts) <= 1
    assert t.chat_batch(CONVS, temperature=0.0) == [
        t.chat(c, temperature=0.0) for c in CONVS]
    path = tmp_path / "m.gguf"
    write_gguf_model(path)
    j, t = _both(path)
    assert t.quantized
    prompts = [t._encode_prompt(c) for c in CONVS]
    assert _agree_until_near_tie(j, t, prompts) <= 1


def test_tensor_parallel_request_decodes_dp_tp(monkeypatch):
    """TPU_DECODE_TP with more than one card of the runner's kind (four
    CPU devices stand for four cards) decodes dp×tp on auto_mesh_for's
    mesh, (2, 2) for tiny_test's 2 KV heads, with the unsharded runner's
    answers; one card decodes unsharded."""
    from classmate_rag_tpu_torch.parallel import mesh as tmesh

    single = TR.DecodeRunner(config=T.DecoderConfig.tiny_test(),
                             device="cpu", **RUN)
    monkeypatch.setenv("TPU_DECODE_TP", "1")
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device=None: [torch.device("cpu")] * 4)
    r = TR.DecodeRunner(config=T.DecoderConfig.tiny_test(), device="cpu",
                        **RUN)
    assert r._mesh.shape == {"data": 2, "model": 2}
    assert r.chat_batch(CONVS, temperature=0.0) == single.chat_batch(
        CONVS, temperature=0.0)
    assert r.chat(CONVS[0], temperature=0.0) == single.chat(
        CONVS[0], temperature=0.0)
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device=None: [torch.device("cpu")])
    r = TR.DecodeRunner(config=T.DecoderConfig.tiny_test(), device="cpu",
                        **RUN)
    assert r._mesh is None and isinstance(r.params["lm_head"], torch.Tensor)


def _cfg(monkeypatch, **env):
    from classmate_rag_tpu_torch.config import load_config

    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    return load_config(reload=True)


def test_get_runner_builds_the_decoder(tmp_path, monkeypatch):
    write_hf_checkpoint(tmp_path / "hf")
    r = TR.get_runner(_cfg(monkeypatch, LLM_BACKEND="auto",
                           TPU_DECODER_MODEL_DIR=tmp_path / "hf"),
                      device="cpu")
    assert isinstance(r, TR.DecodeRunner) and r.has_pretrained_weights
    monkeypatch.delenv("TPU_DECODER_MODEL_DIR")
    path = tmp_path / "Llama-3.1-8B-Instruct.Q4_K_M.gguf"
    write_gguf_model(path)
    for backend in ("tpu", "auto"):
        r = TR.get_runner(_cfg(monkeypatch, LLM_BACKEND=backend,
                               LLM_MODEL_PATH=path, TPU_DECODE_MAX_SEQ=64),
                          device="cpu")
        assert isinstance(r, TR.DecodeRunner)
        assert r.model_name == path.name and r.max_seq == 64
    # A GGUF that does not parse: auto falls through to the extractive
    # runner, tpu to the decoder with drawn weights — the JAX package's
    # rule.
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"GGUF")
    with pytest.raises(struct.error):
        TR.DecodeRunner(model_dir=str(bad), device="cpu", **RUN)
    r = TR.get_runner(_cfg(monkeypatch, LLM_BACKEND="auto",
                           LLM_MODEL_PATH=bad), device="cpu")
    assert isinstance(r, TR.ExtractiveRunner)


def test_missing_card_propagates(tmp_path, monkeypatch):
    """A decoder asked for on CUDA without a card raises; it never turns
    into an extractive answer."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a card")
    path = tmp_path / "m.gguf"
    write_gguf_model(path)
    for backend in ("tpu", "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            TR.get_runner(_cfg(monkeypatch, LLM_BACKEND=backend,
                               LLM_MODEL_PATH=path))


QUESTIONS = ["what is the derivative", "how long do I cook the pasta",
             "eigenvalues of matrices topic3"]


def _decoder_runtimes(monkeypatch, tmp_path, jax_side=True):
    """Runtimes of both packages over the documents of
    tests/test_torch_pipeline.py, answering with a tiny decoder at
    temperature 0."""
    import test_torch_pipeline as P

    write_hf_checkpoint(tmp_path / "decoder")
    monkeypatch.setattr(P.j_ingest, "datetime", P._FixedNow)
    monkeypatch.setattr(P.t_ingest, "datetime", P._FixedNow)
    docs = tmp_path / "docs"
    docs.mkdir()
    for name, text in (("calc.md", P.CALC), ("pasta.txt", P.PASTA),
                       ("algebra.md", P.LONG)):
        (docs / name).write_text(text)
    env = dict(LLM_BACKEND="tpu", LLM_TEMPERATURE="0", LLM_MAX_TOKENS="8",
               TPU_DECODER_MODEL_DIR=str(tmp_path / "decoder"))
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline.runtime import get_runtime

    jrt = None
    if jax_side:
        from classmate_rag_tpu.metadata import (
            normalize_cli_metadata as jmeta,
        )
        from classmate_rag_tpu.pipeline.runtime import get_runtime as j_get

        P._env(monkeypatch, tmp_path / "j", **env)
        jrt = j_get(reload=True)
        for name in ("calc.md", "pasta.txt", "algebra.md"):
            P.j_ingest.ingest_file(path=docs / name, doc_meta=jmeta(),
                                   runtime=jrt)
    P._env(monkeypatch, tmp_path / "t", **env)
    trt = get_runtime(reload=True, device="cpu")
    for name in ("calc.md", "pasta.txt", "algebra.md"):
        P.t_ingest.ingest_file(path=docs / name,
                               doc_meta=normalize_cli_metadata(), runtime=trt)
    return jrt, trt


def test_ask_with_decoder_matches_jax(tmp_path, monkeypatch):
    import test_torch_pipeline as P
    from classmate_rag_tpu.metadata import normalize_cli_metadata as jmeta
    from classmate_rag_tpu.pipeline.ask import (
        ask_question as jask, ask_question_batch as jbatch,
    )
    from classmate_rag_tpu_torch.metadata import (
        normalize_cli_metadata as tmeta,
    )
    from classmate_rag_tpu_torch.pipeline.ask import (
        ask_question as task, ask_question_batch as tbatch,
    )

    jrt, trt = _decoder_runtimes(monkeypatch, tmp_path)
    assert isinstance(trt.runner, TR.DecodeRunner)
    for q in QUESTIONS[:2]:
        a = jask(question=q, filters=jmeta(), top_k=3, runtime=jrt)
        b = task(question=q, filters=tmeta(), top_k=3, runtime=trt)
        P._same_result(a, b)
        assert b.answer
    a = jbatch(questions=QUESTIONS, filters=jmeta(), top_k=3, runtime=jrt)
    b = tbatch(questions=QUESTIONS, filters=tmeta(), top_k=3, runtime=trt)
    for x, y in zip(a, b):
        P._same_result(x, y)


def test_runtime_builds_one_runner(tmp_path, monkeypatch):
    """The port's runtime builds its runner once, on its own device, and
    every ask reuses it (the JAX package builds one per ask); the answers
    are those of a freshly built runner."""
    from classmate_rag_tpu_torch.metadata import normalize_cli_metadata
    from classmate_rag_tpu_torch.pipeline import runtime as R
    from classmate_rag_tpu_torch.pipeline.ask import (
        ask_question, ask_question_batch,
    )

    built = []
    real = R.get_runner

    def counting(cfg, **kw):
        built.append(kw.get("device"))
        return real(cfg, **kw)

    monkeypatch.setattr(R, "get_runner", counting)
    _jrt, trt = _decoder_runtimes(monkeypatch, tmp_path, jax_side=False)
    meta = normalize_cli_metadata()
    first = ask_question(question=QUESTIONS[0], filters=meta, runtime=trt)
    again = ask_question_batch(questions=QUESTIONS[1:], filters=meta,
                               runtime=trt)
    assert built == [torch.device("cpu")]
    assert trt.runner.device == torch.device("cpu")
    fresh = R.get_runtime(reload=True, device="cpu")
    assert fresh.runner is not trt.runner and len(built) == 2
    assert ask_question(question=QUESTIONS[0], filters=meta,
                        runtime=fresh).answer == first.answer
    assert [r.answer for r in ask_question_batch(
        questions=QUESTIONS[1:], filters=meta, runtime=fresh)] == [
        r.answer for r in again]
    R.reset_runtime()
