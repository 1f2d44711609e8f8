"""The port's attention (classmate_rag_tpu_torch/ops/attention.py) vs a
numpy softmax with a key-padding mask, and vs the JAX encoder's non-flash
``_attend`` on the same inputs.

Tolerance: the plain version rounds q, k, v and the probabilities to
bf16 and its output to bf16, as the reference path does; against an f64
numpy softmax of the bf16-rounded q, k, v, the error is that of the
probability and output roundings, max |Δ| ≤ 1e-2 for |v| ≤ 1. Against
the JAX einsum path (the same roundings) max |Δ| ≤ 1 bf16 spacing
(2^-7 for |x| < 1).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classmate_rag_tpu.embeddings import model as jmodel
from classmate_rag_tpu_torch.ops import attention as tatt


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(b, t, nh, hd, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(0, 1.0, (b, t, nh, hd)).astype(np.float32)
            for _ in range(2))
    v = rng.uniform(-1, 1, (b, t, nh, hd)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
    return q, k, v, mask.astype(np.int32)


def _numpy_attention(q, k, v, mask, scale):
    q, k, v = (_bf16(x).astype(np.float64) for x in (q, k, v))
    s = np.einsum("bqnd,bknd->bnqk", q, k) * scale
    s = np.where(mask[:, None, None, :] == 1, s, -np.inf)
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    b, t, nh, hd = q.shape
    return np.einsum("bnqk,bknd->bqnd", p, v).reshape(b, t, nh * hd)


# (T, lengths): T = 256 with rows whose last key tiles are all padding
# (length 40: 3 of 4 tiles of 64), a row of one real token, a full row.
CASES = [
    (32, [32, 7, 1]),
    (128, [128, 64, 65, 1]),
    (256, [40, 256, 1, 130]),
]


@pytest.mark.parametrize("t,lengths", CASES)
@pytest.mark.parametrize("hd", [16, 64])
def test_attention_matches_numpy_softmax(t, lengths, hd):
    nh = 2
    q, k, v, mask = _inputs(len(lengths), t, nh, hd, lengths)
    scale = 1.0 / math.sqrt(hd)
    got = tatt.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(mask), scale)
    assert got.dtype == torch.bfloat16 and got.shape == (len(lengths), t,
                                                         nh * hd)
    got = got.float().numpy()
    assert np.isfinite(got).all()            # pad-query rows included
    want = _numpy_attention(q, k, v, mask, scale)
    assert np.abs(got - want).max() <= 1e-2
    assert tatt.LAUNCHES["flash_attn"] == 0  # the CPU launches nothing


@pytest.mark.parametrize("t,lengths", CASES)
def test_attention_matches_jax_attend(t, lengths):
    """The plain version is the JAX encoder's non-flash ``_attend``
    (model.py:285-293). That is a closure inside
    ``encode_from_embeddings``, so its three lines are restated here with
    the module's own NEG_INF."""
    nh, hd = 2, 16
    q, k, v, mask = _inputs(len(lengths), t, nh, hd, lengths, seed=1)
    cd = jnp.bfloat16
    scores = jnp.einsum("bqnd,bknd->bnqk", jnp.asarray(q).astype(cd),
                        jnp.asarray(k).astype(cd),
                        preferred_element_type=jnp.float32) / math.sqrt(hd)
    bias = (1.0 - jnp.asarray(mask, jnp.float32))[:, None, None, :] \
        * jmodel.NEG_INF
    probs = jax.nn.softmax(scores + bias, axis=-1)
    want = np.asarray(jnp.einsum(
        "bnqk,bknd->bqnd", probs.astype(cd), jnp.asarray(v).astype(cd),
        preferred_element_type=jnp.float32).reshape(len(lengths), t, nh * hd))
    got = tatt.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        1.0 / math.sqrt(hd)).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -7


def test_all_masked_row_is_uniform():
    """A row with no real key gets the reference's uniform softmax
    (NEG_INF is finite and added), not NaN."""
    q, k, v, mask = _inputs(1, 8, 1, 16, [0])
    got = tatt.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.from_numpy(mask), 0.25).float().numpy()
    want = _bf16(v).mean(axis=1)                      # [1, 1, 16]
    assert np.abs(got - want[:, None, 0, :]).max() <= 1e-2


def test_flash_attention_rejects_bad_inputs():
    x = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError):
        tatt.flash_attention(x, x, torch.zeros(2, 8, 2, 8),
                             torch.ones(2, 8), 0.25)
    with pytest.raises(ValueError):
        tatt.flash_attention(x, x, x, torch.ones(2, 7), 0.25)
