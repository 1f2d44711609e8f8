"""The port's masked top-k (classmate_rag_tpu_torch/ops/topk.py) vs the
JAX package's ``topk_xla`` and ``topk_pallas`` (interpret mode).

Tolerances: rows must be equal (the lowest-row tie rule decides every
tie); values agree to 1e-3 against bf16 scans (both sides sum bf16
products in f32, in different orders) and to 1e-5 for f32 corpora.
The kernel-vs-plain cases are in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from classmate_rag_tpu.ops.topk import NEG_INF, topk_pallas, topk_xla
from classmate_rag_tpu_torch.ops import topk as ttopk


def _rand(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port(E, q, bias, k, dtype=torch.bfloat16):
    v, i = ttopk.masked_topk(
        torch.from_numpy(E).to(dtype), torch.from_numpy(q),
        torch.from_numpy(bias), k,
    )
    return v.numpy(), i.numpy()


def _jax_bf16(E, q, bias, k, **kw):
    fn = topk_pallas if kw else topk_xla
    v, i = fn(jnp.asarray(E, jnp.bfloat16), jnp.asarray(q),
              jnp.asarray(bias), k, **kw)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize("case", ["masked_block", "masked_stride"])
def test_reference_matches_xla_and_pallas(case):
    E = _rand(600, 128)
    q = _rand(4, 128, seed=2)
    bias = np.zeros(600, np.float32)
    if case == "masked_block":
        bias[5:50] = NEG_INF
    else:
        bias[::3] = NEG_INF
    v0, i0 = _port(E, q, bias, 8)
    v1, i1 = _jax_bf16(E, q, bias, 8)
    v2, i2 = _jax_bf16(E, q, bias, 8, tile_n=256, interpret=True)
    assert np.array_equal(i0, i1) and np.array_equal(i0, i2)
    np.testing.assert_allclose(v0, v1, atol=1e-3)
    np.testing.assert_allclose(v0, v2, atol=1e-3)


def test_cross_tile_duplicate_ties_pick_lowest_row():
    E = _rand(512, 64)
    E[300:308] = E[10:18]   # exact copies in a different 256-row tile
    q = E[10:12] + 0.0
    bias = np.zeros(512, np.float32)
    v0, i0 = _port(E, q, bias, 12, dtype=torch.float32)
    v1, i1 = topk_pallas(jnp.asarray(E), jnp.asarray(q), jnp.asarray(bias),
                         12, tile_n=256, interpret=True)
    assert np.array_equal(i0, np.asarray(i1))
    np.testing.assert_allclose(v0, np.asarray(v1), atol=1e-5)
    # The originals (rows 10..17) precede their copies at equal scores.
    assert i0[0, 0] == 10 and i0[0, 1] == 300


def test_multi_tile_partial_merge():
    E = _rand(1024, 64, seed=5)
    q = _rand(3, 64, seed=6)
    bias = np.zeros(1024, np.float32)
    bias[100:400] = NEG_INF
    v0, i0 = _port(E, q, bias, 24)
    v2, i2 = _jax_bf16(E, q, bias, 24, tile_n=128, interpret=True)
    assert np.array_equal(i0, i2)
    np.testing.assert_allclose(v0, v2, atol=1e-3)


def test_all_masked_corpus():
    E = _rand(100, 32)
    q = _rand(2, 32)
    bias = np.full(100, NEG_INF, np.float32)
    v0, i0 = _port(E, q, bias, 5)
    v1, i1 = _jax_bf16(E, q, bias, 5)
    assert np.all(v0 <= NEG_INF / 2)
    assert np.array_equal(i0, i1)


def test_k_above_rows_pads():
    E = _rand(3, 16)
    q = _rand(1, 16, seed=1)
    v, i = _port(E, q, np.zeros(3, np.float32), 5)
    assert i[0, 3:].tolist() == [-1, -1] and np.all(v[0, 3:] == NEG_INF)


def test_lexsort_desc_matches_numpy():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 4, size=(5, 40)).astype(np.float32)
    rows = np.stack([rng.permutation(40) for _ in range(5)]).astype(np.int64)
    want = np.lexsort((rows, -vals), axis=1)
    got = ttopk.lexsort_desc(torch.from_numpy(vals), torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["k0", "k129", "empty", "shape"])
def test_wrapper_rejects(bad):
    E = torch.zeros((8, 16), dtype=torch.bfloat16)
    q = torch.zeros((2, 16))
    b = torch.zeros(8)
    k = {"k0": 0, "k129": 129}.get(bad, 4)
    if bad == "empty":
        E, b = E[:0], b[:0]
    if bad == "shape":
        q = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        ttopk.masked_topk(E, q, b, k)
