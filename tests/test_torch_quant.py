"""The port's int8 scan with exact rescore (classmate_rag_tpu_torch/ops/
quant.py) against the JAX package's ops/quant.py on the same seeded
inputs, and the JAX package's own three cases (tests/test_quant.py) on
the port.

Tolerances: ``quantize_rows`` bit-equal (the same numpy code); stage 1
exact (int8 × int8 → int32 sums, then the same f32 scaling in the same
order), so its candidates are EQUAL to JAX's; the final rows EQUAL and
the rescored values within rtol 1e-5 (f32 sums of exact bf16 products in
another order than XLA's dot: a few ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classmate_rag_tpu.ops.quant import quantize_rows as j_quantize
from classmate_rag_tpu.ops.quant import topk_int8_rescore as j_rescore
from classmate_rag_tpu_torch.ops.quant import (
    int8_candidates,
    int8_scores,
    quantize_rows,
    topk_int8_rescore,
)
from classmate_rag_tpu_torch.ops.topk import topk_reference

NEG = np.finfo(np.float32).min


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _corpus(seed=1, n=3000, d=64, nq=6):
    rng = np.random.default_rng(seed)
    E = _unit(rng, n, d)
    E[5] = E[9]                       # a tie the pool must break low-row
    qs = E[:nq] + 0.3 * rng.standard_normal((nq, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    bias[::7] = NEG
    return E, qs, bias


def _j_stage1(ei8, sc, qs, bias, pool):
    """The JAX package's stage 1 (ops/quant.py, quantize to top_k)."""
    q = jnp.asarray(qs)
    q_scale = jnp.maximum(jnp.max(jnp.abs(q), axis=1, keepdims=True)
                          / 127.0, 1e-12)
    q_i8 = jnp.clip(jnp.round(q / q_scale), -127, 127).astype(jnp.int8)
    approx_i32 = jax.lax.dot_general(
        q_i8, jnp.asarray(ei8), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    approx = approx_i32.astype(jnp.float32) * q_scale * jnp.asarray(sc)[None]
    approx = approx + jnp.asarray(bias)[None]
    return np.asarray(jax.lax.top_k(approx, pool)[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((200, 48)).astype(np.float32) * 3
    E[3] = 0.0                        # a zero row: scale 0
    E[4, :] = -1e-3
    q, s = quantize_rows(E)
    jq, js = j_quantize(E)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))


def test_int8_scores_exact():
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (5, 40), dtype=np.int8)
    b = rng.integers(-127, 128, (70, 40), dtype=np.int8)
    got = int8_scores(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("pool", [16, 64])
def test_stage1_candidates_equal_jax(pool):
    E, qs, bias = _corpus()
    ei8, sc = quantize_rows(E)
    got = int8_candidates(torch.from_numpy(ei8), torch.from_numpy(sc),
                          torch.from_numpy(qs), torch.from_numpy(bias),
                          pool)
    np.testing.assert_array_equal(got.numpy(),
                                  _j_stage1(ei8, sc, qs, bias, pool))


@pytest.mark.parametrize("k,pool", [(10, 64), (8, 8), (5, 32)])
def test_rescore_matches_jax(k, pool):
    E, qs, bias = _corpus(n=2000, d=96)
    ei8, sc = quantize_rows(E)
    jv, jr = j_rescore(
        jnp.asarray(ei8), jnp.asarray(sc), jnp.asarray(E, jnp.bfloat16),
        jnp.asarray(qs), jnp.asarray(bias), k, rescore_pool=pool)
    tv, tr = topk_int8_rescore(
        torch.from_numpy(ei8), torch.from_numpy(sc),
        torch.from_numpy(E).to(torch.bfloat16), torch.from_numpy(qs),
        torch.from_numpy(bias), k, rescore_pool=pool)
    assert tr.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)


def test_quantize_roundtrip_error_small():
    rng = np.random.default_rng(0)
    E = _unit(rng, 100, 64)
    q, s = quantize_rows(E)
    back = q.astype(np.float32) * s[:, None]
    assert np.abs(back - E).max() / np.abs(E).max() < 0.01


def test_topk_set_matches_bf16_scan():
    rng = np.random.default_rng(1)
    N, d, k = 5000, 128, 10
    E = _unit(rng, N, d)
    qs = E[:4] + 0.3 * rng.standard_normal((4, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    bias = np.zeros(N, np.float32)
    bias[::7] = NEG
    emb16 = torch.from_numpy(E).to(torch.bfloat16)
    ei8, sc = quantize_rows(E)
    _, r1 = topk_reference(emb16, torch.from_numpy(qs),
                           torch.from_numpy(bias), k)
    _, r2 = topk_int8_rescore(
        torch.from_numpy(ei8), torch.from_numpy(sc), emb16,
        torch.from_numpy(qs), torch.from_numpy(bias), k, rescore_pool=64)
    for i in range(4):
        assert set(r1[i].tolist()) == set(r2[i].tolist())
    assert bool((r2 % 7 != 0).all())   # masked rows never appear


def test_zero_rows_and_tiny_corpus():
    E = np.zeros((3, 16), np.float32)
    E[0, 0] = 1.0
    q, s = quantize_rows(E)
    assert s[1] == 0.0 or (q[1] == 0).all()
    vals, rows = topk_int8_rescore(
        torch.from_numpy(q), torch.from_numpy(s),
        torch.from_numpy(E).to(torch.bfloat16), torch.from_numpy(E[:1]),
        torch.zeros(3), k=5, rescore_pool=2)
    assert rows.shape == (1, 5)
    assert int(rows[0, 0]) == 0
    assert rows[0, 2:].tolist() == [-1, -1, -1]
    assert bool((vals[0, 2:] == NEG).all())
