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
from classmate_rag_tpu_torch.utils.numerics import NEG_INF


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
    with pytest.raises(ValueError):    # the D kernel takes bf16 only
        tatt.flash_attn_bwd_delta(torch.zeros(2, 8, 64),
                                  torch.zeros(2, 8, 64), 1)


@pytest.mark.parametrize("t,lengths", [(16, [16, 5, 1]),
                                       (128, [128, 64, 65, 1])])
def test_attention_grads_match_jax_mha_reference(t, lengths):
    """The plain version's autograd (what the CPU trains through, and
    what the backward kernels are held against on the card) against the
    JAX library's own reference gradients
    (``flash_attention.mha_reference``, flash_attention.py:1530, with
    segment ids), with the output gradient zero on pad query rows, as
    the encoder's pooling gives it: dq on real rows, dk and dv on every
    row (pad keys get none in either form). f32 throughout; tolerance
    1e-4 relative to the largest gradient (f32 sums in other orders)."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference,
    )

    nh, hd = 2, 64
    q, k, v, mask = _inputs(len(lengths), t, nh, hd, lengths, seed=4)
    rng = np.random.default_rng(5)
    dout = rng.normal(0, 1, (len(lengths), t, nh * hd)).astype(np.float32)
    dout *= mask[:, :, None]
    scale = 1.0 / math.sqrt(hd)

    def jax_attn(q, k, v):
        # Its backward takes sm_scale 1 only: the scale goes on q.
        out = mha_reference(*(x.transpose(0, 2, 1, 3)
                              for x in (q * scale, k, v)),
                            None, SegmentIds(q=mask, kv=mask))
        return out.transpose(0, 2, 1, 3).reshape(len(lengths), t, nh * hd)

    _, vjp = jax.vjp(jax_attn, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.attention_reference(tq, tk, tv, torch.from_numpy(mask), scale,
                                   dtype=torch.float32)
    out.backward(torch.from_numpy(dout))
    real = mask.astype(bool)
    for name, got, w, rows in (("dq", tq.grad, want[0], real),
                               ("dk", tk.grad, want[1], None),
                               ("dv", tv.grad, want[2], None)):
        got = got.numpy()
        if rows is not None:
            got, w = got[rows], w[rows]
        err = np.abs(got - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


def _lse2(q, k, mask, scale):
    """The forward's base-2 log-sum-exp [B, heads, T] (what flash_attn
    writes for the backward), in f64 over the same logits."""
    s = np.einsum("bqnd,bknd->bnqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale * tatt.LOG2E
    s = s + np.where(mask[:, None, None, :] == 1, 0.0, NEG_INF)
    m = s.max(axis=-1)
    return (m + np.log2(np.exp2(s - m[..., None]).sum(axis=-1))).astype(
        np.float32)


def _bwd_reference(q, k, v, mask, dout, scale):
    """``flash_attn_bwd`` on CPU tensors (the plain from-LSE backward),
    fed the f32 plain forward's output and the base-2 LSE."""
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    out = tatt.attention_reference(tq, tk, tv, tm, scale,
                                   dtype=torch.float32)
    got = tatt.flash_attn_bwd(tq, tk, tv, out, torch.from_numpy(dout), tm,
                              torch.from_numpy(_lse2(q, k, mask, scale)),
                              scale)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("t,lengths", [
    (16, [16, 5, 1]),
    (128, [128, 64, 65, 1]),
    (200, [200, 73, 1]),          # T cuts the 128-key blocks
    (256, [40, 256, 129, 1]),     # row 0: its second key block all padding
])
def test_bwd_reference_matches_jax_mha_reference(t, lengths):
    """The plain from-LSE backward (what the kernels compute, and what
    ``flash_attn_bwd`` runs on CPU tensors) against the JAX library's
    reference gradients (``mha_reference`` with segment ids, through
    ``jax.vjp``), with the output gradient zero on pad query rows: dq on
    real rows, dk and dv on every row. f32 throughout; tolerance 1e-4
    relative to the largest gradient (f32 sums in other orders, P from
    the LSE rather than a softmax)."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds, mha_reference,
    )

    nh, hd = 2, 64
    b = len(lengths)
    q, k, v, mask = _inputs(b, t, nh, hd, lengths, seed=6)
    rng = np.random.default_rng(7)
    dout = rng.normal(0, 1, (b, t, nh * hd)).astype(np.float32)
    dout *= mask[:, :, None]
    scale = 1.0 / math.sqrt(hd)

    def jax_attn(q, k, v):
        out = mha_reference(*(x.transpose(0, 2, 1, 3)
                              for x in (q * scale, k, v)),
                            None, SegmentIds(q=mask, kv=mask))
        return out.transpose(0, 2, 1, 3).reshape(b, t, nh * hd)

    _, vjp = jax.vjp(jax_attn, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    got = _bwd_reference(q, k, v, mask, dout, scale)
    real = mask.astype(bool)
    for name, g, w, rows in (("dq", got[0], want[0], real),
                             ("dk", got[1], want[1], None),
                             ("dv", got[2], want[2], None)):
        assert g.dtype == np.float32 and g.shape == (b, t, nh, hd)
        if rows is not None:
            g, w = g[rows], w[rows]
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


def test_bwd_reference_matches_autograd_row_without_keys():
    """A batch row with no real key (P = 1/T over its T keys), a row of
    one real key and a full one, every query row with an output
    gradient: the plain from-LSE backward against the plain forward's
    autograd, f32, 1e-4 relative to the largest gradient."""
    nh, hd, t = 2, 64, 16
    lengths = [0, 1, 16]
    q, k, v, mask = _inputs(len(lengths), t, nh, hd, lengths, seed=8)
    rng = np.random.default_rng(9)
    dout = rng.normal(0, 1, (len(lengths), t, nh * hd)).astype(np.float32)
    scale = 0.125
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tatt.attention_reference(tq, tk, tv, torch.from_numpy(mask), scale,
                                   dtype=torch.float32)
    out.backward(torch.from_numpy(dout))
    got = _bwd_reference(q, k, v, mask, dout, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, (tq.grad, tk.grad,
                                                     tv.grad)):
        w = w.numpy()
        assert np.abs(w[0]).max() > 0, name      # the uniform row has one
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)
