"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a GPU machine
without them: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
Without a CUDA card every case skips.

Tolerance: the kernel and the plain version both sum bf16 products in
f32, in different orders, so scores agree to 1e-5 (unit-norm rows);
rows must be equal except at positions whose two neighbouring scores
lie within 1e-5, where a different summation order may swap them.
"""

import numpy as np
import pytest
import torch

from classmate_rag_tpu_torch.ops import topk as ttopk
from classmate_rag_tpu_torch.utils.numerics import NEG_INF


def _rand(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan is a CUDA kernel")
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
     (20000, 768, 256, 32)],
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
