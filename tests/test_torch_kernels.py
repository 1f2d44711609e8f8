"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
Without a CUDA card every case skips.

Tolerances:
- topk_scan: the kernel and the plain version both sum bf16 products in
  f32, in different orders, so scores agree to 1e-5 (unit-norm rows);
  rows must be equal except at positions whose two neighbouring scores
  lie within 1e-5, where a different summation order may swap them.
- row_select: rows and values EQUAL, bit for bit, to the stable sort of
  the biased scores it replaces (the same f32 add, the sort's order).
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
- bm25_sat_gemm (the approx route's BM25 core): its tail postings, made
  dense, EQUAL to the plain core's tail matrix (integer tf); its bf16
  operand EQUAL, bit for
  bit, to the plain ``sat.to(torch.bfloat16)`` (read back through one-hot
  weights); scores within 4e-5 of the row's |w| @ sat, + 1e-6 (bf16
  products, exact in f32, summed on the tensor cores in another order);
  after the approx route's exact pool rescore, rows and values EQUAL.
- the store's packed step (one pinned, non-blocking upload of the
  batch metadata) vs the unpacked step on the same arrays uploaded one
  by one: rows EQUAL, scores within 1e-6 (the same ops on the same
  values; the scan and merge kernels run in both).
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
@pytest.mark.parametrize("b,n,k", [(256, 20_000, 8), (256, 20_000, 256),
                                   (3, 50_001, 64), (1, 300_000, 128),
                                   (8, 100, 200)])
def test_row_select_matches_stable_sort(cuda, b, n, k):
    """BM25-shaped rows (mostly zeros, ties), every ninth bias NEG_INF;
    one block a row (B 256) and slices plus a merge (B 1, 3, 8)."""
    rng = np.random.default_rng(n + k)
    scores = np.where(rng.random((b, n)) < 0.01,
                      rng.integers(1, 9, (b, n)) * 0.5, 0.0)
    bias = np.zeros(n, np.float32)
    bias[::9] = NEG_INF
    s = torch.from_numpy(scores.astype(np.float32)).to(cuda)
    bi = torch.from_numpy(bias).to(cuda)
    before = ttopk.LAUNCHES["row_select"]
    v, r, admitted = ttopk.row_select(s, bi, k)
    want_v, want_r = ttopk.stable_topk(s + bi[None, :], k)
    assert torch.equal(r, want_r)
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
    assert ttopk.LAUNCHES["row_select"] == before + 1
    assert 0 < admitted.item() <= b * n


@pytest.mark.cuda
def test_row_select_rejects_wrong_inputs(cuda):
    s = torch.zeros((4, 512), device=cuda)
    bias = torch.zeros(512, device=cuda)
    before = dict(ttopk.LAUNCHES)
    with pytest.raises(ValueError):
        ttopk.row_select(s, bias, 257)
    with pytest.raises(ValueError):       # contiguous, not 16-byte aligned
        ttopk.row_select(torch.zeros(4 * 512 + 1, device=cuda)[1:]
                         .view(4, 512), bias, 8)
    with pytest.raises(ValueError):
        ttopk.row_select(s, bias.cpu(), 8)
    assert ttopk.LAUNCHES == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4101, 200_010])
def test_int8_scores_on_the_card_any_corpus_rows(cuda, n):
    """``torch._int_mm`` takes only multiples of 8 columns: a corpus of
    any row count is padded with zero rows and cut back."""
    from classmate_rag_tpu_torch.ops.quant import int8_scores

    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-127, 128, (n, 60), dtype=np.int8))
    q8 = torch.from_numpy(rng.integers(-127, 128, (5, 60), dtype=np.int8))
    got = int8_scores(q8.to(cuda), a.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (5, n)
    assert torch.equal(got.cpu(), int8_scores(q8, a))


@pytest.mark.cuda
def test_packed_store_step_equals_unpacked_on_card(cuda):
    """``hybrid_topk_batch`` on 3 batches queued with no sync in between
    (each a fresh pinned buffer, copied without the host waiting) gives
    the rows of the unpacked step over the same arrays, each uploaded
    pinned and non-blocking on its own."""
    from classmate_rag_tpu_torch.index.lexical import (
        STEP_COLUMNS,
        pack_query_terms,
    )
    from classmate_rag_tpu_torch.index.store import IndexStore
    from classmate_rag_tpu_torch.ops.hybrid_step import (
        hybrid_query_step_split,
    )

    rng = np.random.default_rng(7)
    n, d, b = 20_000, 768, 64
    words = [f"w{i}" for i in range(3000)]
    p = 1.0 / np.arange(1, 3001)
    p /= p.sum()
    docs = [list(rng.choice(words, size=40, p=p)) for _ in range(n)]
    emb = _rand(n, d, seed=8)
    store = IndexStore(d, slab_rows=4096, terms_per_chunk=64, device=cuda)
    store.upsert([f"c{i}" for i in range(n)], emb, docs,
                 [{} for _ in range(n)])
    batches = []
    for j in range(3):
        which = rng.integers(0, n, size=b)
        q = emb[which] + 0.1 * _rand(b, d, seed=9 + j)
        batches.append((q / np.linalg.norm(q, axis=1, keepdims=True),
                        [docs[i][:4] for i in which]))
    store.hybrid_topk_batch(*batches[0]).rows.cpu()     # place the store
    outs = [store.hybrid_topk_batch(q, terms) for q, terms in batches]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            cuda, non_blocking=True)

    for (q, terms), out in zip(batches, outs):
        args, kw = store.hybrid_step_inputs(q, terms)
        knobs = {k: v for k, v in kw.items()
                 if k not in ("h", "u", "t", "b", "m")}
        q_terms, q_counts = pack_query_terms(store.vocab, terms, 32)
        qa = store._split_query_arrays(q_terms, q_counts)
        want = hybrid_query_step_split(
            *args[:7], up(q.astype(np.float32)),
            *(up(qa[c]) for c in STEP_COLUMNS), up(q_terms), up(q_counts),
            up(np.any(q_terms >= 0, axis=1, keepdims=True)), *args[9:],
            **knobs)
        assert torch.equal(out.rows.cpu(), want.rows.cpu())
        for name in ("fused", "vec_dist", "bm25_score"):
            torch.testing.assert_close(getattr(out, name).cpu(),
                                       getattr(want, name).cpu(),
                                       rtol=0, atol=1e-6, equal_nan=True)
        assert (out.rows >= 0).all()


# ---------------------------------------------------------------------------
# bm25_sat_gemm: the approx route's BM25 core (ops/bm25_core.py)
# ---------------------------------------------------------------------------

def _tail_windows(rng, n, t_live, t_pad, r_cap):
    """Term-sorted tail postings of ``t_live`` terms over ``n`` rows and
    their window table: long lists cut into several r_cap segments, and
    for every third term an overlay window after the base postings that
    moves some of its rows to a new tf (their base entries set to 0), as
    ``plan_tail_delta`` leaves them. Returns (post_rows, post_tfs,
    u_starts, u_lens, u_cols, t_tids) as numpy arrays, padded as
    ``split_query_arrays`` pads them."""
    base_rows, base_tfs, segs, ov_rows, ov_tfs, ov_segs = [], [], [], [], [], []
    pos = 0
    for j in range(t_live):
        m = int(rng.integers(1, 3 * r_cap))
        rows = np.sort(rng.choice(n, size=min(m, n), replace=False))
        tfs = rng.integers(1, 30, size=len(rows)).astype(np.uint8)
        if j % 3 == 0 and len(rows) > 2:
            moved = rows[1::2][:r_cap]
            tfs[1::2][:len(moved)] = 0
            ov_rows.append(moved)
            ov_tfs.append(rng.integers(1, 255, size=len(moved)).astype(np.uint8))
            ov_segs.append((j, len(moved)))
        base_rows.append(rows)
        base_tfs.append(tfs)
        for k in range(0, len(rows), r_cap):
            segs.append((pos + k, min(r_cap, len(rows) - k), j))
        pos += len(rows)
    p_base = pos
    for (j, ln), rows in zip(ov_segs, ov_rows):
        segs.append((pos, ln, j))
        pos += ln
    size = pos + r_cap + 64
    post_rows = np.zeros(size, np.int32)
    post_tfs = np.zeros(size, np.uint8)
    post_rows[:p_base] = np.concatenate(base_rows) if base_rows else []
    post_tfs[:p_base] = np.concatenate(base_tfs) if base_tfs else []
    if ov_rows:
        post_rows[p_base:pos] = np.concatenate(ov_rows)
        post_tfs[p_base:pos] = np.concatenate(ov_tfs)
    u = max(8, 1 << int(np.ceil(np.log2(max(len(segs), 1)))))
    u_starts = np.zeros(u, np.int32)
    u_lens = np.zeros(u, np.int32)
    u_cols = np.full(u, -1, np.int32)
    for i, (s, ln, j) in enumerate(segs):
        u_starts[i], u_lens[i], u_cols[i] = s, ln, j
    t_tids = np.full(t_pad, -1, np.int32)
    t_tids[:t_live] = np.arange(t_live) + 1000
    return post_rows, post_tfs, u_starts, u_lens, u_cols, t_tids


def _bm25_case(cuda, b, n, *, h_live, h_pad, t_live, t_pad, seed=0,
               r_cap=512):
    """The kernel's inputs on the card: a sparse u8 head matrix [C, n]
    (every 7th row masked out of ``keep``), ``h_live`` distinct slots
    padded with -1 to ``h_pad``, a tail from ``_tail_windows``, row
    lengths 5-100, avgdl over the kept rows (a tensor on the card, as
    the step has it) and random weights [b, h_pad + t_pad] that are zero
    at padding columns and, where b > 1, for the last query."""
    rng = np.random.default_rng(seed)
    c = h_pad + 8
    tf_head = np.where(rng.random((c, n)) < 0.06,
                       rng.integers(1, 40, size=(c, n)), 0).astype(np.uint8)
    tf_head[0, :7] = [255, 200, 64, 1, 2, 3, 17]
    h_slots = np.full(h_pad, -1, np.int32)
    h_slots[:h_live] = rng.choice(c, size=h_live, replace=False)
    windows = _tail_windows(rng, n, t_live, t_pad, r_cap)
    doc_len = rng.integers(5, 101, size=n).astype(np.float32)
    keep = np.ones(n, bool)
    keep[::7] = False
    w = rng.uniform(0.1, 9.0, size=(b, h_pad + t_pad)).astype(np.float32)
    w[:, h_live:h_pad] = 0.0
    w[:, h_pad + t_live:] = 0.0
    if b > 1:
        w[-1] = 0.0
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    post_rows, post_tfs, u_starts, u_lens, u_cols, t_tids = map(up, windows)
    avgdl = up(np.float32(doc_len[keep].mean()))
    return dict(tf_head=up(tf_head), h_slots=up(h_slots), post_rows=post_rows,
                post_tfs=post_tfs, u_starts=u_starts, u_lens=u_lens,
                u_cols=u_cols, t_tids=t_tids, doc_len=up(doc_len),
                keep=up(keep), avgdl=avgdl.reshape(()),
                w=up(w).to(torch.bfloat16), r_cap=r_cap)


def _bm25_kernel_and_plain(cs):
    """The kernel's and the plain version's scores on the same operands,
    and the tail's postings and its dense tf [T, N]."""
    from classmate_rag_tpu_torch.ops import bm25_core

    n = cs["tf_head"].shape[1]
    tail = bm25_core.tail_postings(cs["post_rows"], cs["post_tfs"],
                                   cs["u_starts"], cs["u_lens"],
                                   cs["u_cols"], n, cs["r_cap"])
    args = (cs["tf_head"], cs["h_slots"], tail, cs["doc_len"], cs["keep"],
            cs["avgdl"], cs["w"])
    got = bm25_core.sat_gemm(*args)
    want = bm25_core.sat_gemm_reference(*args)
    return got, want, bm25_core.tail_matrix(tail, cs["t_tids"].shape[0], n)


def _bm25_operand(cs, tail_tf):
    """The plain bf16 operand of the head slots' rows, then the tail's."""
    from classmate_rag_tpu_torch.ops import bm25_core

    head = cs["tf_head"][cs["h_slots"].clamp(min=0).long()] * (
        cs["h_slots"] >= 0)[:, None]
    return bm25_core.sat_operand(torch.cat((head, tail_tf), 0),
                                 cs["doc_len"], cs["keep"], cs["avgdl"])


# (B, N, live head slots, padded, live tail terms, padded): B 1, 7 (one
# 64-query block), 256 and 300 (two 256-query blocks); N ragged (not a
# multiple of 16: the kernel's byte loads; not of 128: a partial block),
# a shard's width of the 1M corpus, and a few full blocks.
BM25_CASES = [
    (1, 4096 + 77, 3, 8, 2, 8),
    (7, 262_144, 40, 64, 20, 32),
    (256, 20_000, 70, 128, 90, 128),
    (256, 262_144 + 16, 130, 256, 60, 64),
    (300, 5000 + 3, 17, 32, 9, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h_live,h_pad,t_live,t_pad", BM25_CASES)
def test_bm25_sat_gemm_matches_plain(cuda, b, n, h_live, h_pad, t_live,
                                     t_pad):
    """Scores within 4e-5 of |w| @ sat (+1e-6) of the plain version (bf16
    products, exact in f32, summed in another order); the tail's postings,
    made dense, EQUAL to the plain core's tail matrix; masked rows and the
    term-less last query exact 0."""
    from classmate_rag_tpu_torch.index import lexical as tlex

    cs = _bm25_case(cuda, b, n, h_live=h_live, h_pad=h_pad, t_live=t_live,
                    t_pad=t_pad, seed=b + n)
    got, want, tail_tf = _bm25_kernel_and_plain(cs)
    sums = tlex.tail_tf_matrix(cs["post_rows"], cs["post_tfs"],
                               cs["u_starts"], cs["u_lens"], cs["u_cols"],
                               t_pad, n, cs["r_cap"])
    scale = cs["w"].float().abs() @ _bm25_operand(cs, tail_tf).float()
    torch.cuda.synchronize()
    assert torch.equal(tail_tf.float(), sums.T)
    assert ((got - want).abs() <= 4e-5 * scale + 1e-6).all()
    assert not got[:, ~cs["keep"]].any() and (b == 1 or not got[-1].any())
    assert (got > 0).sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("h_pad,t_pad", [(64, 64), (32, 24)])
def test_bm25_sat_operand_bit_equal(cuda, h_pad, t_pad):
    """One-hot weights (query q weighs slot q alone) read the kernel's bf16
    operand back exactly: equal, bit for bit, to the plain version's
    ``sat.to(torch.bfloat16)`` times keep, head slots and tail terms
    alike, at 128 and at 56 queries."""
    k = h_pad + t_pad
    cs = _bm25_case(cuda, k, 8192 + 40, h_live=h_pad - 5, h_pad=h_pad,
                    t_live=t_pad - 3, t_pad=t_pad, seed=k)
    cs["w"] = torch.eye(k, device=cuda, dtype=torch.bfloat16)
    got, _, tail_tf = _bm25_kernel_and_plain(cs)
    sat = _bm25_operand(cs, tail_tf)
    want = sat.float() * cs["keep"][None, :]
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (sat[:h_pad].float() > 0).sum() > 1000
    assert (sat[h_pad:].float() > 0).sum() > 100


@pytest.mark.cuda
def test_bm25_select_after_rescore_equals_plain(cuda):
    """The approx route's selection with its exact pool rescore gives EQUAL
    rows and values from the kernel's scores and from the plain core's
    (``bm25_split_score_core(fast=True)`` on the CPU's copy, moved over):
    the rescore fixes the final order. The launches: one kernel each."""
    from classmate_rag_tpu_torch.index import lexical as tlex
    from classmate_rag_tpu_torch.ops import bm25_core
    from classmate_rag_tpu_torch.ops.hybrid_step import bm25_select

    rng = np.random.default_rng(3)
    n_docs, vocab_n = 30_000, 4000
    p = 1.0 / np.arange(1, vocab_n + 1)
    p /= p.sum()
    vocab = {}
    ids = np.full((n_docs, 48), -1, np.int32)
    tfs = np.zeros((n_docs, 48), np.uint8)
    dl = np.zeros(n_docs, np.float32)
    docs = []
    for i in range(n_docs):
        doc = [f"t{j}" for j in rng.choice(vocab_n, size=int(
            rng.integers(12, 60)), p=p)]
        docs.append(doc)
        ids[i], tfs[i], dl[i] = tlex.pack_tokens(doc, vocab, 48)
    vpad = 4096
    lay = tlex.build_split_layout(ids, tfs, len(vocab),
                                  head_bytes_budget=200 * n_docs,
                                  head_df_threshold=64)
    keep = np.ones(n_docs, bool)
    keep[::11] = False
    df = tlex.subset_df(torch.from_numpy(ids), torch.from_numpy(tfs),
                        torch.from_numpy(keep), vpad)
    n_sub = torch.tensor(np.float32(keep.sum()))
    idf = tlex.okapi_idf(df, n_sub)
    avgdl = torch.tensor(np.float32(dl[keep].sum() / keep.sum()))
    queries = [docs[i][:7] for i in rng.choice(n_docs, size=64)]
    q_terms, q_counts = tlex.pack_query_terms(vocab, queries, 8)
    qa = tlex.split_query_arrays(lay["lut"], lay["offsets"], q_terms,
                                 q_counts, r_cap=lay["r_cap"])
    args = [lay["tf_head"], lay["post_rows"], lay["post_tfs"], dl, keep, idf,
            avgdl, qa["h_slots"], qa["h_tids"], qa["u_starts"], qa["u_lens"],
            qa["u_cols"], qa["t_tids"], q_terms, q_counts]
    cpu = [torch.as_tensor(np.asarray(x)) for x in args]
    dev = [x.to(cuda) for x in cpu]
    kw = dict(vocab_pad=vpad, r_cap=lay["r_cap"], fast=True)
    before = dict(bm25_core.LAUNCHES)
    got = tlex.bm25_split_score_core(*dev, **kw)
    assert bm25_core.LAUNCHES == {k: v + 1 for k, v in before.items()}
    want = tlex.bm25_split_score_core(*cpu, **kw).to(cuda)
    bias = torch.where(dev[4], 0.0, NEG_INF)
    ctx = (torch.from_numpy(ids).to(cuda), torch.from_numpy(tfs).to(cuda),
           dev[3], dev[6], dev[5], dev[13], dev[14])
    out = [bm25_select(s, bias, 8, select="approx", rescore_ctx=ctx)
           for s in (got, want)]
    torch.cuda.synchronize()
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0].view(torch.int32), out[1][0].view(torch.int32))
    assert (out[0][0] > 0).all()


@pytest.mark.cuda
def test_bm25_sat_gemm_rejects_wrong_inputs(cuda):
    from classmate_rag_tpu_torch.ops import bm25_core

    cs = _bm25_case(cuda, 4, 4096, h_live=5, h_pad=8, t_live=3, t_pad=8)
    n = cs["tf_head"].shape[1]
    tail = bm25_core.tail_postings(cs["post_rows"], cs["post_tfs"],
                                   cs["u_starts"], cs["u_lens"],
                                   cs["u_cols"], n, cs["r_cap"])
    ok = [cs["tf_head"], cs["h_slots"], tail, cs["doc_len"], cs["keep"],
          cs["avgdl"], cs["w"]]
    before = dict(bm25_core.LAUNCHES)
    bad = [
        (2, tail._replace(off=tail.off.cpu())),          # wrong device
        (5, cs["avgdl"].cpu()),
        (0, cs["tf_head"].float()),                      # wrong dtype
        (6, cs["w"].float()),
        (2, tail._replace(rows=tail.rows.long())),
        (6, cs["w"][:, :-3]),                            # H + T not / 8
        (1, cs["h_slots"][:-3]),                         # H not / 8
        (2, tail._replace(off=tail.off[:-1])),           # wrong shape
        (0, cs["tf_head"].t().contiguous().t()),         # not contiguous
    ]
    for i, x in bad:
        with pytest.raises((TypeError, ValueError)):
            bm25_core.sat_gemm(*ok[:i], x, *ok[i + 1:])
    assert bm25_core.LAUNCHES == before
