"""The port's driver entry points (classmate_rag_tpu_torch/graft_entry.py)
against the root ``__graft_entry__.py`` and the JAX package's functions,
on the CPU.

- ``entry()``: the example batch EQUAL to the reference's; E5-base's
  forward at full width within tests/test_torch_encoder.py's bars (per-row
  cosine >= 0.9999, max |Δ| <= 1e-3) of the reference's ``fn(*args)``; the
  port's parameters equal to the reference's draw on a few leaves (f32
  embeddings exact, matmul weights at their bf16 values).
- ``dryrun_multichip``: its inputs equal to the reference dryrun's draws
  (one default_rng(0), the reference's order); each stage on ``[cpu] * 4``
  against the JAX package on the same numpy inputs: (a) loss within rel
  1e-3 of the JAX step on its 4-device training mesh (bf16 compute); (b)
  and (c) rows EQUAL and fused scores within 1e-5 of the single-device
  ``hybrid_query_step`` / ``hybrid_query_step_split``; (d) tokens EQUAL to
  ``make_generate_fn``'s; (f) vectors within 1e-6 of one device's
  encode. The whole run passes (stage (e)'s assertions included) and
  leaves the environment, the config and the runtime singleton as it
  found them. Without CUDA, the default device raises.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref
from classmate_rag_tpu.embeddings import model as jm
from classmate_rag_tpu.index import lexical as jlex
from classmate_rag_tpu.models import decoder as JD
from classmate_rag_tpu.ops.hybrid_step import (
    hybrid_query_step as j_step,
    hybrid_query_step_split as j_split_step,
)
from classmate_rag_tpu.parallel import training_mesh as j_training_mesh
from classmate_rag_tpu.training import make_train_step as j_make_train
from classmate_rag_tpu_torch import graft_entry as g
from classmate_rag_tpu_torch.config import load_config
from classmate_rag_tpu_torch.pipeline import runtime as trt

N = 4
CPU4 = [torch.device("cpu")] * N
COS_MIN, ABS_MAX = 0.9999, 1e-3
LOSS_RTOL = 1e-3


@pytest.fixture(scope="module")
def entries():
    """The reference's (fn, (params, ids, mask)) and its forward, and the
    port's (fn, (ids, mask)) on the CPU: E5-base drawn once a side."""
    jfn, jargs = ref.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    yield jargs, want, g.entry(device="cpu")


def test_entry_inputs_equal_reference(entries):
    (_params, ids, mask), _want, (_fn, (tids, tmask)) = entries
    assert tids.dtype == tmask.dtype == torch.int32
    assert tids.device.type == "cpu"
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))


def test_entry_forward_matches_reference(entries):
    _jargs, want, (fn, args) = entries
    assert not fn.training and fn.config == g.EncoderConfig.base()
    with torch.inference_mode():
        got = fn(*args)
    assert tuple(got.shape) == (8, 768) and got.dtype == torch.float32
    got = got.numpy()
    assert (got * want).sum(axis=1).min() >= COS_MIN
    assert np.abs(got - want).max() <= ABS_MAX


def test_entry_params_equal_reference_on_leaves(entries):
    (params, _ids, _mask), _want, (fn, _args) = entries
    for key in ("word_emb", "pos_emb", "type_emb"):
        assert torch.equal(getattr(fn, key),
                           torch.tensor(np.asarray(params[key]))), key
    lay = params["layers"]

    def bf16(x):
        return torch.tensor(np.asarray(x, np.float32)).bfloat16()

    qkv0 = torch.cat([bf16(lay[k][0]) for k in ("q_w", "k_w", "v_w")], 1)
    assert torch.equal(fn.qkv_w[0], qkv0)
    assert torch.equal(fn.ff_out_w[-1], bf16(lay["ff_out_w"][-1]))


def _reference_draws(n_devices):
    """The reference dryrun's random inputs, drawn as its body draws them
    (__graft_entry__.py, stages (a), (b) and (d))."""
    rng = np.random.default_rng(0)
    data_axis = j_training_mesh(n_devices).shape["data"]
    batch = data_axis * max(2, -(-8 // data_axis))
    vocab = jm.EncoderConfig.small_test().vocab_size
    q_ids = rng.integers(4, vocab, (batch, 16))
    p_ids = rng.integers(4, vocab, (batch, 16))
    n_rows = 16 * n_devices
    emb = rng.standard_normal((n_rows, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    term_ids = rng.integers(0, 500, (n_rows, 16)).astype(np.int32)
    tfs = rng.integers(1, 4, (n_rows, 16)).astype(np.uint8)
    prompt = rng.integers(4, JD.DecoderConfig.tiny_test().vocab_size,
                          (2 * data_axis, 5))
    return dict(q_ids=q_ids, p_ids=p_ids, emb=emb, term_ids=term_ids,
                tfs=tfs, prompt=prompt, data_axis=data_axis)


@pytest.fixture(scope="module")
def inputs():
    return g.dryrun_inputs(CPU4)


def test_dryrun_inputs_equal_reference_draws(inputs):
    want = _reference_draws(N)
    assert len(inputs["prompt"]) == 2 * want["data_axis"]
    for key in ("q_ids", "p_ids", "emb", "term_ids", "tfs", "prompt"):
        np.testing.assert_array_equal(inputs[key], want[key], err_msg=key)
    np.testing.assert_array_equal(inputs["q_vecs"], want["emb"][:2] + 0.01)
    np.testing.assert_array_equal(inputs["q_terms"],
                                  want["term_ids"][:2, :8])
    assert inputs["mask"].shape == inputs["q_ids"].shape
    assert (inputs["mask"] == 1).all()


def test_stage_a_train_matches_jax(inputs):
    loss = g.stage_train(CPU4, inputs)
    config = jm.EncoderConfig.small_test()
    init_state, train_step = j_make_train(config, j_training_mesh(N),
                                          learning_rate=1e-3)
    state = init_state(jm.init_params(config, "dryrun"))
    mask = jnp.asarray(inputs["mask"])
    _state, want = train_step(state, jnp.asarray(inputs["q_ids"]), mask,
                              jnp.asarray(inputs["p_ids"]), mask)
    assert loss == pytest.approx(float(want), rel=LOSS_RTOL)


def _jax_corpus(x):
    emb_bf = jnp.asarray(x["emb"], jnp.bfloat16)
    term_ids, tfs = jnp.asarray(x["term_ids"]), jnp.asarray(x["tfs"])
    subset_df, _ = jlex.device_fns()
    df = subset_df(term_ids, tfs, jnp.ones(len(x["bias"]), bool),
                   g.VOCAB_PAD)
    return emb_bf, term_ids, tfs, df


def _same(rows, fused, want):
    np.testing.assert_array_equal(rows, np.asarray(want.rows))
    np.testing.assert_allclose(fused, np.asarray(want.fused), rtol=0,
                               atol=1e-5)


def test_stage_b_sharded_step_matches_jax(inputs):
    rows, fused = g.stage_sharded_hybrid(CPU4, inputs)
    x = inputs
    emb_bf, term_ids, tfs, df = _jax_corpus(x)
    want = j_step(
        emb_bf, term_ids, tfs, jnp.asarray(x["doc_len"]), df,
        jnp.asarray(x["bias"]), jnp.asarray(x["q_vecs"]),
        jnp.asarray(x["q_terms"]), jnp.asarray(x["q_counts"]),
        top_k=4, vocab_pad=g.VOCAB_PAD,
    )
    assert rows.shape == (2, 4)
    _same(rows, fused, want)


def test_stage_c_split_step_matches_jax(inputs):
    rows, fused = g.stage_split_hybrid(CPU4, inputs)
    x = inputs
    emb_bf, _term_ids, _tfs, df = _jax_corpus(x)
    layout = jlex.build_split_layout(
        x["term_ids"], x["tfs"], 500, head_bytes_budget=1 << 20,
        head_df_threshold=2,
    )
    qa = jlex.split_query_arrays(layout["lut"], layout["offsets"],
                                 x["q_terms"], x["q_counts"],
                                 r_cap=layout["r_cap"])
    has_terms = np.any(x["q_terms"] >= 0, axis=1, keepdims=True)
    want = j_split_step(
        emb_bf, jnp.asarray(layout["tf_head"]),
        jnp.asarray(layout["post_rows"]), jnp.asarray(layout["post_tfs"]),
        jnp.asarray(x["doc_len"]), df, jnp.asarray(x["bias"]),
        jnp.asarray(x["q_vecs"]),
        *(jnp.asarray(qa[k]) for k in ("h_slots", "h_tids", "u_starts",
                                       "u_lens", "u_cols", "t_tids")),
        jnp.asarray(x["q_terms"]), jnp.asarray(x["q_counts"]),
        jnp.asarray(has_terms), r_cap=layout["r_cap"], top_k=4,
        vocab_pad=g.VOCAB_PAD,
    )
    _same(rows, fused, want)


def test_stage_d_tp_decode_matches_jax(inputs):
    got = g.stage_tp_decode(CPU4, inputs)
    config = dataclasses.replace(JD.DecoderConfig.tiny_test(),
                                 compute_dtype=jnp.float32, kv_heads=4)
    want = JD.make_generate_fn(config, 24, 6)(
        JD.init_params(config, "dryrun-tp"), jnp.asarray(inputs["prompt"]),
        jnp.asarray(inputs["prompt_len"]), 0, 0.0, 1.0, 2)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_stage_f_dp_encode_matches_one_device():
    many, one = g.stage_dp_encode(CPU4)
    assert many.shape == one.shape == (16, 64)
    assert np.isfinite(many).all()
    np.testing.assert_allclose(many, one, rtol=0, atol=1e-6)


def test_dryrun_multichip_runs_every_stage_and_restores_state(monkeypatch):
    sentinel = object()
    monkeypatch.setattr(trt, "_RUNTIME", sentinel)
    local = trt.local_devices
    env = dict(os.environ)
    config = load_config(reload=True)
    out = g.dryrun_multichip(N, device="cpu")
    assert out["devices"] == ["cpu"] * N
    assert set(out["seconds"]) == set(out["launches"]) == set("abcdef")
    assert all(out[s] is not None for s in "abcdef")
    e = out["e"]
    assert e["got"] == e["want"] and e["victim"] not in e["after"]
    # The CPU runs every kernel's plain version: nothing is launched.
    assert not any(n for s in out["launches"].values() for n in s.values())
    assert trt._RUNTIME is sentinel and trt.local_devices is local
    assert dict(os.environ) == env
    assert load_config() == config


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (g.entry, lambda: g.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
