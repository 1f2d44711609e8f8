"""The port's fused-epilogue plain versions (classmate_rag_tpu_torch/ops/
encoder_fused.py) vs the JAX package's Pallas kernels in interpret mode
and its XLA reference formulas, on the same numpy inputs.

Tolerances (u = the spacing of bf16 values at the result):
- bias_gelu: within 0.75 u + 2e-6 of XLA's exact gelu, the bound of the
  JAX package's own test (tests/test_encoder_fused.py, written there as
  1.5 half-spacings): both round an f32 GELU to bf16, and two erf
  evaluations may put a value on either side of a rounding boundary;
  within 1.5 u + 2e-6 of the Pallas kernel, whose polynomial erf may
  move its result one grid point more;
- residual_ln: rtol = atol = 1e-5 (f32, other summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from classmate_rag_tpu.embeddings.model import _layer_norm as j_layer_norm
from classmate_rag_tpu.ops import encoder_fused as jef
from classmate_rag_tpu_torch.ops import encoder_fused as tef


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (frexp mantissa in [0.5, 1), 8
    significant bits)."""
    _, e = np.frexp(x)
    return np.ldexp(1.0, e - 8).astype(np.float32)


@pytest.mark.parametrize("n,f", [(8, 128), (64, 3072), (24, 256)])
def test_bias_gelu_matches_jax(n, f):
    rng = np.random.default_rng(0)
    y = rng.normal(0, 2.0, (n, f)).astype(np.float32)
    b = rng.normal(0, 0.5, (f,)).astype(np.float32)
    got = tef.bias_gelu(torch.from_numpy(y), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (n, f)
    got = got.float().numpy()
    xla = np.asarray(jax.nn.gelu(jnp.asarray(y + b), approximate=False),
                     np.float32)
    assert np.all(np.abs(got - xla) <= 0.75 * _bf16_ulp(xla) + 2e-6)
    pallas = np.asarray(jef.bias_gelu(jnp.asarray(y), jnp.asarray(b),
                                      out_dtype=jnp.bfloat16, interpret=True),
                        np.float32)
    assert np.all(np.abs(got - pallas) <= 1.5 * _bf16_ulp(xla) + 2e-6)
    # The counter moves only where a kernel launches: never on the CPU.
    assert tef.LAUNCHES["bias_gelu"] == 0


def test_bias_gelu_far_tail_is_exact():
    """erfc keeps the far negative tail, where 1 + erf(x/√2) cancels to
    0 in f32 (gelu(-8) is -5e-15, not -0)."""
    y = torch.tensor([[-8.0, -6.0, -5.0, -4.0, 0.0, 4.0, 6.0, 30.0]])
    got = tef.bias_gelu(y, torch.zeros(8)).float().numpy()[0]
    xla = np.asarray(jax.nn.gelu(jnp.asarray(y.numpy()), approximate=False),
                     np.float32)[0]
    assert np.all(np.abs(got - xla) <= 0.5 * _bf16_ulp(xla))   # rounding
    assert got[0] < 0 and got[-1] == 30.0


@pytest.mark.parametrize("n,h", [(8, 128), (64, 768), (512, 768)])
def test_residual_ln_matches_jax(n, h):
    rng = np.random.default_rng(1)
    resid, y = (rng.normal(0, 1.0, (n, h)).astype(np.float32)
                for _ in range(2))
    b, beta = (rng.normal(0, 0.1, (h,)).astype(np.float32)
               for _ in range(2))
    g = rng.normal(1, 0.1, (h,)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (resid, y, b, g, beta)]
    got = tef.residual_ln(*t, eps=1e-5).numpy()
    pallas = np.asarray(jef.residual_ln(
        *[jnp.asarray(a) for a in (resid, y, b, g, beta)], eps=1e-5,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    unfused = np.asarray(j_layer_norm(
        jnp.asarray(resid) + (jnp.asarray(y) + jnp.asarray(b)),
        jnp.asarray(g), jnp.asarray(beta), 1e-5))
    np.testing.assert_allclose(got, unfused, rtol=1e-5, atol=1e-5)
    assert tef.LAUNCHES["residual_ln"] == 0


@pytest.mark.parametrize("n,w", [(16384, 768), (16384, 3072), (16384, 700),
                                 (12, 768), (0, 128)])
def test_fusable_gate_matches_jax(n, w):
    assert tef.fusable(n, w) == jef.fusable(n, w)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(3.0, 2.0, (40, 64)).astype(np.float32)
    g = rng.normal(1, 0.1, 64).astype(np.float32)
    b = rng.normal(0, 0.1, 64).astype(np.float32)
    got = tef.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b), 1e-5).numpy()
    want = np.asarray(j_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b), 1e-5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        tef.bias_gelu(torch.zeros(4, 8), torch.zeros(7))
    with pytest.raises(ValueError):
        tef.residual_ln(torch.zeros(4, 8), torch.zeros(4, 8),
                        torch.zeros(8), torch.zeros(8), torch.zeros(9), 1e-5)
