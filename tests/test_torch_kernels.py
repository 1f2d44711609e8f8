"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
Without a CUDA card every case skips.

Tolerances:
- topk_scan: the kernel and the plain version both sum bf16 products in
  f32, in different orders, so scores agree to 1e-5 (unit-norm rows);
  rows must be equal except at positions whose two neighbouring scores
  lie within 1e-5, where a different summation order may swap them.
- bias_gelu: ≤ 1 bf16 spacing (both round the same f32 GELU to bf16;
  the erfc evaluations may differ in the last f32 bit and so land on
  either side of a rounding boundary).
- residual_ln: ≤ 1e-5 (f32, other summation orders).
- flash_attn: max |Δ| ≤ 1e-2 for |v| ≤ 1 (the kernel rounds the
  unnormalised probabilities to bf16, the plain version the normalised
  ones: each weight differs by up to 2^-9 relative), and every row,
  pad-query rows included, finite.
- the encoder on the card vs on the CPU: per-row cosine ≥ 0.9999.
- flash_attn_bwd (with its D kernel, flash_attn_bwd_delta): dq, dk and
  dv against the plain version's autograd, and against the plain
  from-LSE backward (``flash_attn_bwd_reference``), on the same bf16
  inputs and output gradient: cosine ≥ 0.9999 and max |Δ| ≤ 2e-2 ·
  max |plain| (the kernel rounds P, dS and the gradients to bf16, the
  plain versions at other points or not at all); D within 1e-5 relative
  of torch's f32 sum; the LSE the forward writes for them within 1e-4
  of torch's (base 2, f32), and the forward output with it bit-equal to
  the serving forward's.
- the int8 scan's stage 1 (``ops/quant.py``, ``torch._int_mm`` with its
  query and width padding): int32 scores and candidates EQUAL to the
  CPU's int32 product (exact integer sums).
"""

import numpy as np
import pytest
import torch

from classmate_rag_tpu_torch.ops import attention as tatt
from classmate_rag_tpu_torch.ops import encoder_fused as tef
from classmate_rag_tpu_torch.ops import topk as ttopk
from classmate_rag_tpu_torch.utils.numerics import NEG_INF


def _rand(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these are CUDA kernels")
    return torch.device("cuda")


def _assert_same_topk(E, q, bias, k, tol=1e-5):
    """Kernel vs plain; the plain version's (k+1)-th score shows whether
    the k-th position is a near-tie with a row just outside the list."""
    v1, i1 = ttopk.masked_topk(E, q, bias, k)
    v0, i0 = ttopk.topk_reference(E, q, bias, k + 1)
    torch.cuda.synchronize()
    assert (v1 - v0[:, :k]).abs().max().item() < tol
    near = (v0[:, 1:] - v0[:, :-1]).abs() < tol           # [Q, k]
    pad = torch.nn.functional.pad
    ok = (i1 == i0[:, :k]) | near | pad(near[:, :-1], (1, 0))
    assert bool(ok.all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,nq,k",
    [(5000, 64, 70, 32), (2048 * 3 + 77, 128, 3, 128), (300, 768, 1, 1),
     (20000, 768, 256, 32), (20000, 768, 100, 48), (3000, 104, 5, 8)],
)
def test_topk_scan_matches_plain(cuda, n, d, nq, k):
    E = torch.from_numpy(_rand(n, d)).to(torch.bfloat16).to(cuda)
    q = torch.from_numpy(_rand(nq, d, seed=1)).to(cuda)
    bias = torch.zeros(n, device=cuda)
    bias[::10] = NEG_INF
    before = ttopk.LAUNCHES["topk_scan"]
    _assert_same_topk(E, q, bias, k)
    assert ttopk.LAUNCHES["topk_scan"] == before + 1


@pytest.mark.cuda
def test_topk_scan_ties_and_all_masked(cuda):
    E = _rand(5000, 64)
    E[4100:4108] = E[10:18]          # copies two chunks later
    Et = torch.from_numpy(E).to(torch.bfloat16).to(cuda)
    q = torch.from_numpy(E[10:12].copy()).to(cuda)
    bias = torch.zeros(5000, device=cuda)
    v1, i1 = ttopk.masked_topk(Et, q, bias, 16)
    v0, i0 = ttopk.topk_reference(Et, q, bias, 16)
    assert torch.equal(i1, i0) and i1[0, 0].item() == 10
    assert i1[0, 1].item() == 4100
    bias.fill_(NEG_INF)
    v1, i1 = ttopk.masked_topk(Et, q, bias, 8)
    v0, i0 = ttopk.topk_reference(Et, q, bias, 8)
    assert torch.equal(i1, i0) and bool((v1 <= NEG_INF / 2).all())


def _last_slice_of_one_row(nq, d, k, device):
    """An N whose last kernel slice holds exactly one row."""
    for tiles in range(2, 4096):
        n = tiles * 128 + 1
        _s, rows = ttopk.kernel_slices(n, nq, d, k, device)
        if n % rows == 1:
            return n
    raise AssertionError("no N with a one-row last slice")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dup_other_slice", "identical_rows",
                                  "below_one_tile", "one_past_slice",
                                  "q_ragged_k1", "k128"])
def test_topk_scan_slice_edges(cuda, case):
    """Edges of the slice walk: ties across slices and inside one, a
    corpus smaller than a tile, a one-row last slice, Q not a multiple of
    the 64-query block, and the smallest and largest k."""
    d, nq, k, n = 128, 5, 16, 5000
    if case == "below_one_tile":
        n = 77
    elif case == "one_past_slice":
        d, nq, k = 64, 256, 32
        n = _last_slice_of_one_row(nq, d, k, cuda)
    elif case == "q_ragged_k1":
        nq, k = 70, 1
    elif case == "k128":
        d, nq, k, n = 768, 70, 128, 20000
    E = _rand(n, d)
    bias = torch.zeros(n, device=cuda)
    if case == "dup_other_slice":
        n = 50000
        E = _rand(n, d)
        E[n // 2] = E[10]
        bias = torch.zeros(n, device=cuda)
        n_slices, rows = ttopk.kernel_slices(n, 2, d, 12, cuda)
        assert n_slices > 1 and 10 // rows != (n // 2) // rows
        Et = torch.from_numpy(E).to(torch.bfloat16).to(cuda)
        q = Et[10:12].float()
        v1, i1 = ttopk.masked_topk(Et, q, bias, 12)
        v0, i0 = ttopk.topk_reference(Et, q, bias, 12)
        assert torch.equal(i1, i0) and i1[0, :2].tolist() == [10, n // 2]
        return
    if case == "identical_rows":
        E = np.repeat(_rand(1, d), n, axis=0)
        Et = torch.from_numpy(E).to(torch.bfloat16).to(cuda)
        q = torch.from_numpy(_rand(nq, d, seed=1)).to(cuda)
        v1, i1 = ttopk.masked_topk(Et, q, bias, k)
        v0, i0 = ttopk.topk_reference(Et, q, bias, k)
        want = torch.arange(k, dtype=torch.int32, device=cuda).expand(nq, k)
        assert torch.equal(i1, want) and torch.equal(i0, want)
        assert (v1 - v0).abs().max().item() < 1e-5
        return
    bias[::9] = NEG_INF
    Et = torch.from_numpy(E).to(torch.bfloat16).to(cuda)
    q = torch.from_numpy(_rand(nq, d, seed=1)).to(cuda)
    _assert_same_topk(Et, q, bias, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k,lists", [(1, 7), (32, 66), (128, 3), (24, 40)])
def test_topk_merge_matches_plain(cuda, k, lists):
    """The merge kernel vs merge_partials on random sorted lists with
    never-filled slots, masked scores and equal scores across lists."""
    rng = np.random.default_rng(k + lists)
    nq = 9
    vals = rng.normal(0, 0.1, (nq, lists, k)).astype(np.float32)
    vals[:, ::3, -k // 3:] = NEG_INF                  # masked rows
    vals[:, 1, : k // 2 + 1] = vals[:, 0, : k // 2 + 1]  # ties across lists
    rows = rng.permutation(nq * lists * k * 4)[: nq * lists * k]
    rows = rows.reshape(nq, lists, k).astype(np.int32)
    vals[:, 2::5, k // 2:] = -np.inf                  # never filled
    rows[:, 2::5, k // 2:] = -1
    v = torch.from_numpy(vals).to(cuda)
    r = torch.from_numpy(rows).to(cuda)
    # Sort everything, then cut into lists: each list sorted, in order.
    order = ttopk.lexsort_desc(
        v.reshape(nq, -1), torch.where(r < 0, 2**31 - 1, r).reshape(nq, -1))
    v = v.reshape(nq, -1).gather(1, order).reshape(nq, lists, k)
    r = r.reshape(nq, -1).gather(1, order).reshape(nq, lists, k)
    bounds = torch.zeros(nq, dtype=torch.int32, device=cuda)
    before = ttopk.LAUNCHES["topk_merge"]
    got_v, got_r = ttopk.merge_slices(v, r, bounds, k)
    want_v, want_r = ttopk.merge_partials(v, r, k)
    torch.cuda.synchronize()
    assert ttopk.LAUNCHES["topk_merge"] == before + 1
    assert torch.equal(got_r, want_r) and torch.equal(got_v, want_v)


@pytest.mark.cuda
def test_topk_scan_rejects_wrong_inputs(cuda):
    E = torch.zeros((64, 16), device=cuda)           # f32, not bf16
    with pytest.raises(TypeError):
        ttopk.masked_topk(E, torch.zeros((2, 16), device=cuda),
                          torch.zeros(64, device=cuda), 4)
    Eb = torch.zeros((64, 32), dtype=torch.bfloat16, device=cuda)[:, :16]
    with pytest.raises(ValueError):
        ttopk.masked_topk(Eb, torch.zeros((2, 16), device=cuda),
                          torch.zeros(64, device=cuda), 4)


def _bf16_ulp(x):
    _, e = np.frexp(x)
    return np.ldexp(1.0, e - 8).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(1000, 3072), (77, 3072), (8, 128),
                                 (5, 24)])
def test_bias_gelu_matches_plain(cuda, n, f):
    rng = np.random.default_rng(n)
    y = torch.from_numpy(rng.normal(0, 2.0, (n, f)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, f).astype(np.float32))
    y, b = y.to(cuda), b.to(cuda)
    before = tef.LAUNCHES["bias_gelu"]
    got = tef.bias_gelu(y, b)
    want = tef.bias_gelu_reference(y, b)
    torch.cuda.synchronize()
    assert tef.LAUNCHES["bias_gelu"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, f)
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.all(np.abs(g - w) <= _bf16_ulp(w))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h", [(16384, 768), (3, 1024), (9, 128)])
def test_residual_ln_matches_plain(cuda, n, h):
    rng = np.random.default_rng(h)
    resid, y = (rng.normal(0, 1.0, (n, h)).astype(np.float32)
                for _ in range(2))
    b, beta = (rng.normal(0, 0.1, h).astype(np.float32) for _ in range(2))
    g = rng.normal(1, 0.1, h).astype(np.float32)
    t = [torch.from_numpy(a).to(cuda) for a in (resid, y, b, g, beta)]
    before = tef.LAUNCHES["residual_ln"]
    got = tef.residual_ln(*t, eps=1e-5)
    want = tef.residual_ln_reference(*t, eps=1e-5)
    torch.cuda.synchronize()
    assert tef.LAUNCHES["residual_ln"] == before + 1
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("t,lengths,layout", [
    (512, [40, 512, 1, 300], "fused"),   # 7 of 8 key tiles padding, row 0
    (128, [128, 1, 64, 65, 100, 2, 127, 128], "fused"),
    (100, [100, 3], "fused"),            # T cuts the key and query tiles
    # Lengths on the 64-key tile edges, and a row with no real key.
    (256, [63, 64, 65, 127, 128, 129, 256, 0], "fused"),
    (256, [63, 64, 65, 127, 128, 129, 256, 0], "contiguous"),
    (1, [1, 0], "fused"),                # one key, one query
    (128, 48, "fused"),                  # more items than resident blocks
    (512, 24, "contiguous"),
])
def test_flash_attn_matches_plain(cuda, t, lengths, layout):
    rng = np.random.default_rng(t)
    if isinstance(lengths, int):         # that many rows, random lengths
        lengths = rng.integers(0, t + 1, lengths)
        lengths[:2] = (0, t)
    b, nh, hd = len(lengths), 12, 64
    qkv = rng.normal(0, 1.0, (b, t, 3, nh, hd)).astype(np.float32)
    qkv[:, :, 2] = rng.uniform(-1, 1, (b, t, nh, hd))
    qkv = torch.from_numpy(qkv).to(torch.bfloat16).to(cuda)
    q, k, v = qkv.unbind(2)            # the encoder's strided views
    if layout == "contiguous":         # [B, T, heads, 64] each
        q, k, v = (x.contiguous() for x in (q, k, v))
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
        .astype(np.int32)).to(cuda)
    before = tatt.LAUNCHES["flash_attn"]
    got = tatt.flash_attention(q, k, v, mask, 0.125)
    want = tatt.attention_reference(q, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert tatt.LAUNCHES["flash_attn"] == before + 1
    assert got.shape == (b, t, nh * hd) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert (got.float() - want.float()).abs().max().item() <= 1e-2
    # A row with no real key: the uniform softmax, the mean of V.
    for r in np.flatnonzero(np.asarray(lengths) == 0):
        mean_v = v[r].float().mean(dim=0).reshape(nh * hd)
        assert (got[r].float() - mean_v).abs().max().item() <= 1e-2
    if b >= 24:
        assert b * nh * -(-t // 128) > tatt.resident_ctas() > 0


@pytest.mark.cuda
def test_encoder_kernels_reject_wrong_inputs(cuda):
    x = torch.zeros((2, 8, 2, 32), dtype=torch.bfloat16, device=cuda)
    m = torch.ones((2, 8), device=cuda)
    with pytest.raises(ValueError):               # head_dim 32
        tatt.flash_attention(x, x, x, m, 0.2)
    x = torch.zeros((2, 8, 2, 64), device=cuda)   # f32
    with pytest.raises(TypeError):
        tatt.flash_attention(x, x, x, m, 0.125)
    with pytest.raises(TypeError):
        tef.bias_gelu(torch.zeros((4, 8), dtype=torch.float16, device=cuda),
                      torch.zeros(8, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):               # width 13
        tef.bias_gelu(torch.zeros((4, 13), device=cuda),
                      torch.zeros(13, device=cuda))
    with pytest.raises(ValueError):               # width 96
        v = torch.zeros(96, device=cuda)
        tef.residual_ln(torch.zeros((4, 96), device=cuda),
                        torch.zeros((4, 96), device=cuda), v, v, v, 1e-5)


@pytest.mark.cuda
def test_encoder_on_card_matches_cpu(cuda):
    """Two layers at the E5-base width through every kernel: the fused
    epilogues and flash attention (T = 128) on the card vs the plain
    versions on the CPU, and the launch counts of one forward."""
    import dataclasses

    from classmate_rag_tpu_torch.embeddings import model as tm

    cfg = dataclasses.replace(tm.EncoderConfig.base(), vocab_size=1000,
                              layers=2, fused_epilogue=True,
                              flash_min_seq=128)
    tree = tm.init_params(cfg, "kernel-test")
    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 129, 16)
    mask = (np.arange(128)[None, :] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.integers(4, 1000, (16, 128)), 1)
    ids, mask = torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(mask)
    on_cpu = tm.params_from_numpy(tree, cfg, "cpu").encode(ids, mask)
    model = tm.params_from_numpy(tree, cfg, cuda)
    before = {**tef.LAUNCHES, **tatt.LAUNCHES}
    with torch.no_grad():
        on_card = model.encode(ids.to(cuda), mask.to(cuda)).cpu()
    after = {**tef.LAUNCHES, **tatt.LAUNCHES}
    # Inference launches no backward kernel.
    assert {k: after[k] - before[k] for k in after} == {
        "bias_gelu": 2, "residual_ln": 4, "flash_attn": 2,
        "flash_attn_bwd_delta": 0, "flash_attn_bwd": 0}
    assert (on_card * on_cpu).sum(dim=1).min().item() >= 0.9999


def _bwd_inputs(b, t, lengths, device, seed=0, nh=12):
    """bf16 q, k, v as the encoder's strided views of one leaf that
    requires grad, an int32 key mask and a random output gradient."""
    rng = np.random.default_rng(seed)
    hd = 64
    qkv = rng.normal(0, 1.0, (b, t, 3, nh, hd)).astype(np.float32)
    qkv = torch.from_numpy(qkv).to(torch.bfloat16).to(device)
    qkv.requires_grad_(True)
    mask = torch.from_numpy(
        (np.arange(t)[None, :] < np.asarray(lengths)[:, None])
        .astype(np.int32)).to(device)
    dout = torch.from_numpy(rng.normal(0, 1.0, (b, t, nh * hd))
                            .astype(np.float32)).to(torch.bfloat16)
    return qkv, mask, dout.to(device)


def _attn_grads(fn, qkv, mask, dout):
    qkv.grad = None
    q, k, v = qkv.unbind(2)
    out = fn(q, k, v, mask, 0.125)
    out.backward(dout)
    return out.detach(), qkv.grad.float()


def _launched(before):
    """Backward launches since ``before`` (a copy of LAUNCHES)."""
    return {k: tatt.LAUNCHES[k] - before[k]
            for k in ("flash_attn_bwd_delta", "flash_attn_bwd")}


def _assert_grads_close(got, want):
    for i, name in enumerate(("dq", "dk", "dv")):
        g, w = got[:, :, i].flatten(), want[:, :, i].flatten()
        assert bool(torch.isfinite(g).all()), name
        cos = torch.nn.functional.cosine_similarity(g, w, dim=0).item()
        err = (g - w).abs().max().item()
        assert cos >= 0.9999, (name, cos)
        assert err <= 2e-2 * w.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,nh", [
    (32, 128, 12), (16, 256, 12), (8, 512, 12),
    (4, 200, 12),     # T cuts the 64-row tiles and the 128-key blocks
    (12, 64, 16),     # 192 items: more than the persistent grid holds
])
def test_flash_attn_bwd_matches_plain(cuda, b, t, nh):
    """The fused backward kernel (after its D kernel) against the plain
    version's autograd, with padded rows, a row of one real token and a
    row with no real key: one launch of each a backward."""
    rng = np.random.default_rng(b * t)
    lengths = rng.integers(1, t + 1, b)
    lengths[:3] = (0, 1, t)
    qkv, mask, dout = _bwd_inputs(b, t, lengths, cuda, nh=nh)
    before = dict(tatt.LAUNCHES)
    _out, got = _attn_grads(tatt.flash_attention, qkv, mask, dout)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_attn_bwd_delta": 1,
                                 "flash_attn_bwd": 1}
    if b * nh > 132:
        assert b * nh * -(-t // 128) > tatt.bwd_resident_ctas() > 0
    _out, want = _attn_grads(tatt.attention_reference, qkv, mask, dout)
    _assert_grads_close(got, want)
    # Pad keys of a row with real keys: no gradient.
    for r in np.flatnonzero((lengths > 0) & (lengths < t)):
        pad = mask[r] == 0
        assert got[r, pad, 1:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_attn_lse_and_serving_forward(cuda):
    """The LSE the backward reads, and the forward's output unchanged by
    writing it (the serving call passes no LSE pointer)."""
    b, t, nh = 8, 256, 12
    lengths = np.array([0, 1, 63, 64, 65, 200, 256, 129])
    qkv, mask, _dout = _bwd_inputs(b, t, lengths, cuda, seed=3)
    q, k, v = qkv.detach().unbind(2)
    serving = tatt.flash_attn(q, k, v, mask, 0.125)
    out, lse = tatt.flash_attn(q, k, v, mask, 0.125, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, serving)
    assert lse.shape == (b, nh, t) and lse.dtype == torch.float32
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * 0.125
    s = s + (1.0 - mask.float())[:, None, None, :] * NEG_INF
    want = torch.logsumexp(s, dim=-1) * 1.4426950408889634
    real = torch.from_numpy(lengths > 0).to(cuda)
    assert (lse[real] - want[real]).abs().max().item() <= 1e-4
    assert bool((lse[~real] < NEG_INF / 2).all())   # no real key


@pytest.mark.cuda
def test_flash_attention_vjp_matches_plain_small(cuda):
    """Vector-Jacobian products of ``FlashAttention`` against the plain
    version's at a small shape, for several output gradients, including
    zero gradient on pad query rows (what the encoder's pooling gives)."""
    b, t = 2, 128
    lengths = np.array([128, 37])
    for seed in range(3):
        qkv, mask, dout = _bwd_inputs(b, t, lengths, cuda, seed=seed)
        if seed == 2:
            dout = dout * mask[:, :, None].to(dout.dtype)
        before = dict(tatt.LAUNCHES)
        out, got = _attn_grads(tatt.FlashAttention.apply, qkv, mask, dout)
        torch.cuda.synchronize()
        assert _launched(before) == {"flash_attn_bwd_delta": 1,
                                     "flash_attn_bwd": 1}
        ref_out, want = _attn_grads(tatt.attention_reference, qkv, mask,
                                    dout)
        assert (out.float() - ref_out.float()).abs().max().item() <= 1e-2
        _assert_grads_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,left", [(32, 128, False), (8, 512, False),
                                      (4, 200, False), (8, 256, True)])
def test_flash_attn_bwd_matches_from_lse_reference(cuda, b, t, left):
    """The D kernel against torch's f32 sum, and the fused kernel against
    ``flash_attn_bwd_reference`` (the same function from the same LSE,
    in f32) on one set of inputs, called directly; twice in a row on one
    D call where the f32 workspace is used (T > 128), which the kernel
    leaves ready (its counters reset) for another launch. ``left``: the
    real keys at the end of each row (padding first), so that a row's
    first key blocks are the ones skipped."""
    rng = np.random.default_rng(t)
    lengths = rng.integers(1, t + 1, b)
    lengths[:3] = (0, 1, t)
    qkv, mask, dout = _bwd_inputs(b, t, lengths, cuda, seed=5)
    if left:
        mask = torch.flip(mask, dims=[1]).contiguous()
    q, k, v = qkv.detach().unbind(2)
    nh = q.shape[2]
    out, lse = tatt.flash_attn(q, k, v, mask, 0.125, with_lse=True)
    before = dict(tatt.LAUNCHES)
    delta, ws, count = tatt.flash_attn_bwd_delta(out, dout, nh)
    got = tatt.flash_attn_bwd_fused(q, k, v, dout, mask, lse, delta, ws,
                                    count, 0.125)
    torch.cuda.synchronize()
    assert _launched(before) == {"flash_attn_bwd_delta": 1,
                                 "flash_attn_bwd": 1}
    assert (ws is None) == (t <= 128)
    want_d = (out.float() * dout.float()).view(b, t, nh, 64).sum(-1)
    want_d = want_d.permute(0, 2, 1)
    assert (delta - want_d).abs().max().item() <= (
        1e-5 * want_d.abs().max().item())
    want = tatt.flash_attn_bwd_reference(q, k, v, out, dout, mask, lse,
                                         0.125)
    _assert_grads_close(torch.stack(got, 2).float(),
                        torch.stack(want, 2).float())
    if ws is not None:
        ws.zero_()
        again = tatt.flash_attn_bwd_fused(q, k, v, dout, mask, lse, delta,
                                          ws, count, 0.125)
        torch.cuda.synchronize()
        for a, g in zip(again, got):
            assert (a.float() - g.float()).abs().max().item() <= 2e-2 * (
                g.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("nq,d", [(5, 60), (24, 64), (40, 768)])
def test_int8_stage1_on_the_card_equals_cpu(cuda, nq, d):
    from classmate_rag_tpu_torch.ops.quant import (
        int8_candidates,
        int8_scores,
        quantize_rows,
    )

    E = _rand(4096, d, seed=3)
    qs = _rand(nq, d, seed=4)
    bias = np.zeros(4096, np.float32)
    bias[::7] = NEG_INF
    ei8, sc = quantize_rows(E)
    a = torch.from_numpy(ei8)
    q8 = torch.from_numpy(np.clip(np.rint(qs * 127), -127, 127)
                          .astype(np.int8))
    got = int8_scores(q8.to(cuda), a.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), int8_scores(q8, a))
    args = (torch.from_numpy(sc), torch.from_numpy(qs),
            torch.from_numpy(bias))
    cand = int8_candidates(a.to(cuda), *(x.to(cuda) for x in args), 64)
    assert torch.equal(cand.cpu(), int8_candidates(a, *args, 64))
