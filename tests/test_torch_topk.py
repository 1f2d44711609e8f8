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


# ---------------------------------------------------------------------------
# The host half of the CUDA scan: the slice geometry and the merge of the
# per-slice lists (``merge_partials``, the plain version of the merge
# kernel), held against the plain top-k over the whole corpus.
# ---------------------------------------------------------------------------

def _slice_lists(E, q, bias, k, slice_rows, prune=None):
    """Per-slice lists as the kernel writes them: each slice's top-k of
    the plain version's scores (one matmul over the whole corpus, so a
    row scores the same in every test), rows global, never-filled slots
    (-inf, -1). ``prune`` empties entries strictly below that bound, as
    the kernel's shared bound may."""
    scores = q.to(E.dtype).float() @ E.float().T + bias[None, :]
    vals, rows = [], []
    for start in range(0, E.shape[0], slice_rows):
        v, r = ttopk.stable_topk(scores[:, start:start + slice_rows], k)
        short = k - v.shape[1]
        v = torch.nn.functional.pad(v, (0, short), value=float("-inf"))
        r = torch.nn.functional.pad(r + start, (0, short), value=-1)
        if prune is not None:
            cut = v < prune[:, None]
            v, r = v.masked_fill(cut, float("-inf")), r.masked_fill(cut, -1)
        vals.append(v)
        rows.append(r)
    return torch.stack(vals, 1), torch.stack(rows, 1).to(torch.int32)


def _data(n, d, nq, seed, masked=0.0):
    rng = np.random.default_rng(seed)
    E = torch.from_numpy(_rand(n, d, seed)).to(torch.bfloat16)
    q = torch.from_numpy(_rand(nq, d, seed + 1))
    bias = torch.zeros(n)
    bias[torch.from_numpy(rng.random(n) < masked)] = NEG_INF
    return E, q, bias


@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("n,slice_rows", [(1000, 128), (1000, 384),
                                          (3001, 640), (130, 128),
                                          (5000, 5120)])
def test_merge_partials_matches_plain(k, n, slice_rows):
    """Random slices at several S, ragged last slices, k up to past N."""
    E, q, bias = _data(n, 64, 5, seed=n + k, masked=0.1)
    pv, pr = _slice_lists(E, q, bias, k, slice_rows)
    assert pv.shape[1] == -(-n // slice_rows)
    got_v, got_r = ttopk.merge_partials(pv, pr, k)
    want_v, want_r = ttopk.topk_reference(E, q, bias, k)
    assert torch.equal(got_r, want_r)
    assert torch.equal(got_v, want_v)


@pytest.mark.parametrize("k", [1, 32, 128])
def test_merge_partials_pruned_slices(k):
    """Entries below the k-th score may be missing from any slice (the
    kernel's shared bound drops them): the merge is still exact."""
    E, q, bias = _data(2000, 32, 4, seed=7)
    want_v, want_r = ttopk.topk_reference(E, q, bias, k)
    pv, pr = _slice_lists(E, q, bias, k, 256, prune=want_v[:, -1])
    assert bool((pr < 0).any()) or k == 1
    got_v, got_r = ttopk.merge_partials(pv, pr, k)
    assert torch.equal(got_r, want_r) and torch.equal(got_v, want_v)


def test_merge_partials_interleaved_lists():
    """Lists need not ascend by row: two lists per slice over alternate
    tiles, as the kernel's two consumer warpgroups keep them."""
    E, q, bias = _data(3000, 32, 4, seed=11, masked=0.2)
    E[130:140] = E[0:10]             # ties between the two lists of a slice
    bias[:140] = 0.0
    q = torch.cat([E[0:2].float(), q[2:]])
    tiles = torch.arange(3000) // 128
    vals, rows = [], []
    for start in range(0, 3000, 512):
        for parity in (0, 1):
            keep = torch.zeros(3000, dtype=torch.bool)
            keep[start:start + 512] = True
            keep &= tiles % 2 == parity
            masked_bias = torch.where(keep, bias, torch.tensor(float("-inf")))
            v, r = _slice_lists(E, q, masked_bias, 16, 3000)
            vals.append(v)
            rows.append(r.masked_fill(v == float("-inf"), -1))
    got_v, got_r = ttopk.merge_partials(torch.cat(vals, 1), torch.cat(rows, 1),
                                        16)
    want_v, want_r = ttopk.topk_reference(E, q, bias, 16)
    assert torch.equal(got_r, want_r) and torch.equal(got_v, want_v)
    assert got_r[0, :2].tolist() == [0, 130]


def test_merge_partials_ties_across_a_slice_boundary():
    """Equal scores on both sides of a boundary: the lower row first."""
    E, q, _ = _data(1024, 32, 2, seed=3)
    E[300:310] = E[250:260]          # slice 0 (0..255) and slice 1
    E[700:705] = E[250:255]          # and slice 2
    q = E[250:252].float()
    bias = torch.zeros(1024)
    pv, pr = _slice_lists(E, q, bias, 16, 256)
    got_v, got_r = ttopk.merge_partials(pv, pr, 16)
    want_v, want_r = ttopk.topk_reference(E, q, bias, 16)
    assert torch.equal(got_r, want_r)
    assert got_r[0, :3].tolist() == [250, 300, 700]


def test_merge_partials_masked_and_empty_slices():
    """Whole slices masked (NEG_INF, real rows) sort before never-filled
    slots (-inf, -1), which come out as (NEG_INF, -1)."""
    E, q, _ = _data(600, 32, 3, seed=5)
    bias = torch.zeros(600)
    bias[:256] = NEG_INF             # slice 0 all masked
    bias[512:] = NEG_INF             # the short last slice too
    pv, pr = _slice_lists(E, q, bias, 128, 256)
    got_v, got_r = ttopk.merge_partials(pv, pr, 128)
    want_v, want_r = ttopk.topk_reference(E, q, bias, 128)
    assert torch.equal(got_r, want_r) and torch.equal(got_v, want_v)
    # k past N: the tail is (NEG_INF, -1), after the masked rows.
    pv, pr = _slice_lists(E[:100], q, torch.full((100,), NEG_INF), 128, 64)
    got_v, got_r = ttopk.merge_partials(pv, pr, 128)
    assert got_r[:, :100].tolist() == [list(range(100))] * 3
    assert bool((got_r[:, 100:] == -1).all())
    assert bool((got_v == NEG_INF).all())


@pytest.mark.parametrize("n,qb,resident", [
    (262_144, 4, 132), (1 << 20, 4, 132), (200_000, 1, 132), (77, 2, 132),
    (5000, 2, 264), (128 * 40 + 1, 4, 132), (10_000_000, 300, 132),
    (1 << 24, 1, 2 ** 20),
])
def test_slice_geometry_covers_every_row_once(n, qb, resident):
    s, rows = ttopk.slice_geometry(n, qb, tile_rows=128,
                                   resident_blocks=resident)
    assert rows % 128 == 0 and 1 <= s <= 65535
    starts = [i * rows for i in range(s)]
    stops = [min(n, a + rows) for a in starts]
    assert starts[0] == 0 and stops[-1] == n
    assert all(b == a2 for b, a2 in zip(stops, starts[1:]))   # no gap
    assert all(a < b for a, b in zip(starts, stops))          # none empty
    assert s * qb <= max(resident, qb)                        # one wave
    if n >= 128 * resident:                                   # fills it
        assert s >= min(65535, max(1, resident // qb)) // 2


# ---------------------------------------------------------------------------
# ``row_select``, BM25's selection: the plain version (what CPU tensors
# take, and what the CUDA kernel is held to on the card), its checks, its
# grid, and the kernel's source.
# ---------------------------------------------------------------------------

def _bm25_like(b, n, seed, live=0.02, levels=12):
    """BM25-shaped rows: mostly exact zeros, a few positive values drawn
    from a few levels (ties everywhere)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, levels + 1, size=(b, n)).astype(np.float32) * 0.37
    return torch.from_numpy(np.where(rng.random((b, n)) < live, vals, 0.0)
                            .astype(np.float32))


def _lexsort_topk(biased, k):
    """(value desc, row asc), the first k: the order ``stable_topk``
    keeps, by numpy's lexsort."""
    v = biased.numpy()
    rows = np.broadcast_to(np.arange(v.shape[1]), v.shape)
    order = np.lexsort((rows, -v), axis=1)[:, :k]
    return np.take_along_axis(v, order, 1), order


@pytest.mark.parametrize("case", ["zeros_ties", "ninth_masked", "all_masked",
                                  "fewer_live_than_k", "k_past_n", "k_1"])
def test_row_select_plain_matches_stable_topk(case):
    b, n, k = 5, 3001, 64
    scores = _bm25_like(b, n, seed=len(case))
    bias = torch.zeros(n)
    if case == "ninth_masked":
        bias[::9] = NEG_INF
    elif case == "all_masked":
        bias[:] = NEG_INF
    elif case == "fewer_live_than_k":
        bias[:] = NEG_INF
        bias[100:110] = 0.0           # 10 live rows, k 64
        scores[:, 105] = 0.0          # a live zero among them
    elif case == "k_past_n":
        scores, bias, k = scores[:, :50].contiguous(), bias[:50], 128
    elif case == "k_1":
        k = 1
    vals, rows, admitted = ttopk.row_select(scores, bias, k)
    want_v, want_r = ttopk.stable_topk(scores + bias[None, :], k)
    assert admitted is None
    assert vals.dtype == torch.float32 and rows.dtype == torch.int64
    assert vals.shape == rows.shape == (b, min(k, scores.shape[1]))
    assert torch.equal(rows, want_r) and torch.equal(vals, want_v)
    lex_v, lex_r = _lexsort_topk(scores + bias[None, :], k)
    assert np.array_equal(rows.numpy(), lex_r)
    assert np.array_equal(vals.numpy(), lex_v)
    if case in ("all_masked", "fewer_live_than_k"):
        # Masked rows are real entries: NEG_INF, by row, after the live.
        live = 10 if case == "fewer_live_than_k" else 0
        assert bool((vals[:, live:] == NEG_INF).all())
        masked = rows[:, live:]
        assert bool((masked[:, 1:] > masked[:, :-1]).all())


@pytest.mark.parametrize("bad", ["scores_f64", "bias_f16", "noncontig",
                                 "bias_noncontig", "bias_len", "k0", "dims",
                                 "empty_rows"])
def test_row_select_rejects(bad):
    scores = torch.zeros((4, 64))
    bias = torch.zeros(64)
    k = 0 if bad == "k0" else 8
    err = ValueError
    if bad == "scores_f64":
        scores, err = scores.double(), TypeError
    elif bad == "bias_f16":
        bias, err = bias.half(), TypeError
    elif bad == "noncontig":
        scores = torch.zeros((64, 4)).T
    elif bad == "bias_noncontig":
        bias = torch.zeros(128)[::2]
    elif bad == "bias_len":
        bias = torch.zeros(63)
    elif bad == "dims":
        scores = torch.zeros(64)
    elif bad == "empty_rows":
        scores, bias = torch.zeros((4, 0)), torch.zeros(0)
    before = dict(ttopk.LAUNCHES)
    with pytest.raises(err):
        ttopk.row_select(scores, bias, k)
    assert ttopk.LAUNCHES == before


@pytest.mark.parametrize("b,n", [
    (256, 1 << 20), (256, 262_144), (132, 171_332), (1, 1 << 20),
    (4, 1 << 20), (4, 262_144), (1, 77), (131, 5_000), (2, 16_385),
    (1, 1 << 30), (64, 600_001),
])
def test_row_slices_covers_every_row_once(b, n):
    sms, step, warps = 132, 512, 16
    s, rows = ttopk.row_slices(b, n, sms=sms, step_rows=step,
                               min_block_rows=2 * warps * step)
    assert rows % step == 0 and 1 <= s <= 65535
    starts = [i * rows for i in range(s)]
    stops = [min(n, a + rows) for a in starts]
    assert starts[0] == 0 and stops[-1] == n
    assert all(b_ == a2 for b_, a2 in zip(stops, starts[1:]))  # no gap
    assert all(a < b_ for a, b_ in zip(starts, stops))         # none empty
    if b >= sms:
        assert s == 1                 # one block a row: one launch
    else:
        assert b * s <= 2 * sms + b   # about two blocks an SM
        if n >= 2 * sms * 2 * warps * step:
            assert b * s >= sms       # the card is filled


@pytest.mark.parametrize("k", [1, 8, 64, 256])
def test_row_select_slices_then_merge_is_exact(k):
    """Each slice's first k (rows global), merged by (value desc, row
    asc), is the whole row's first k: the two launches' plan, in plain
    PyTorch, over the slices ``row_slices`` cuts."""
    b, n = 3, 20_000
    scores = _bm25_like(b, n, seed=k, live=0.01)
    bias = torch.zeros(n)
    bias[::9] = NEG_INF
    s, rows = ttopk.row_slices(b, n, sms=132, step_rows=512,
                               min_block_rows=1024)
    assert s > 1
    vals, idx = [], []
    for start in range(0, n, rows):
        v, r, _ = ttopk.row_select(scores[:, start:start + rows].contiguous(),
                                   bias[start:start + rows].contiguous(), k)
        vals.append(v)
        idx.append(r + start)
    vals, idx = torch.cat(vals, 1), torch.cat(idx, 1)
    order = ttopk.lexsort_desc(vals, idx)[:, :k]
    want_v, want_r = ttopk.stable_topk(scores + bias[None, :], k)
    assert torch.equal(idx.gather(1, order), want_r)
    assert torch.equal(vals.gather(1, order), want_v)


def test_row_select_kernel_names_stay_off_the_scan_roofline():
    """rag_bench charges every kernel whose name holds topk_scan_kernel or
    topk_merge_kernel to the dense scan: row_select's kernels must not."""
    import re
    from pathlib import Path

    src = (Path(ttopk.__file__).parent / "csrc" / "row_select.cu").read_text()
    names = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        src))
    assert names == {"row_select_kernel", "row_select_merge_kernel"}
    for name in names:
        assert "topk_scan_kernel" not in name
        assert "topk_merge_kernel" not in name


def test_store_refuses_a_selection_wider_than_the_card_takes():
    """On CUDA ``hybrid_step_inputs`` raises before anything is launched
    when the BM25 selection is wider than ROW_SELECT_MAX_K; the CPU takes
    any width."""
    from classmate_rag_tpu_torch.index.store import IndexStore

    rng = np.random.default_rng(0)
    emb = _rand(300, 16)
    store = IndexStore(16, slab_rows=512, terms_per_chunk=8, device="cpu",
                       select="approx")
    store.upsert([f"c{i}" for i in range(300)], emb,
                 [["alpha", "beta", "gamma"][: 1 + i % 3] for i in range(300)],
                 [{"course": "x"}] * 300)
    q = emb[:2] + 0.01 * rng.standard_normal((2, 16)).astype(np.float32)
    assert store.select_mode == "approx"
    out = store.hybrid_topk_batch(q, [["alpha"], ["beta"]], k_bm25=96)
    assert tuple(out.rows.shape) == (2, 8)
    store.device = torch.device("cuda")  # what the check reads, nothing more
    with pytest.raises(ValueError, match="k_bm25=65"):
        store.hybrid_topk_batch(q, [["alpha"], ["beta"]], k_bm25=65)
    store.select = "exact"
    with pytest.raises(ValueError, match="k_bm25=257"):
        store.hybrid_topk_batch(q, [["alpha"], ["beta"]], k_bm25=257)
