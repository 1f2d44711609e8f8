"""Non-causal attention with a key-padding mask (port of the encoder's
``_attend``, classmate_rag_tpu/embeddings/model.py:269-293).

Layout is the JAX package's: q, k, v [B, T, heads, head_dim] → context
[B, T, heads·head_dim], returned in bf16 (the next matmul's operand
type, which the reference casts it to at once).

- ``attention_reference``: the plain version, the encoder's non-flash
  path: bf16 operands, f32 scores scaled by ``sm_scale``, an additive
  mask bias of (1 − mask)·NEG_INF on the keys, softmax in f32, bf16
  probabilities times bf16 V with f32 sums. It serves every T on any
  device when the flash gate is off, the CPU always, and is the
  yardstick the kernel is held against on the card.
- ``flash_attention``: the wrapper. CPU tensors take the plain version;
  CUDA tensors launch ``csrc/flash_attn.cu`` (head_dim 64 only; TMA,
  ``wgmma`` and a persistent grid of ``resident_ctas()`` blocks, each
  walking (batch row, head, 128-query tile) items), or raise.

The TPU library kernel this replaces took the mask as segment ids,
which also masks pad QUERY rows; the key-padding form leaves those rows
as ordinary rows. Pooling drops them either way.
"""

from __future__ import annotations

import ctypes

import torch

from classmate_rag_tpu_torch.ops import _build
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"flash_attn": 0}

HEAD_DIM = 64   # the only head_dim csrc/flash_attn.cu takes (both E5 sizes)


def attention_reference(
    q: torch.Tensor,        # [B, T, heads, head_dim]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,     # [B, T], nonzero = real token
    sm_scale: float,
) -> torch.Tensor:
    """Plain version → bf16 [B, T, heads·head_dim]."""
    b, t, nh, hd = q.shape
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    # Products of bf16 values are exact in f32, so the f32 einsum is the
    # reference's bf16 einsum with f32 accumulation.
    scores = torch.einsum("bqnd,bknd->bnqk", qf, kf) * sm_scale
    bias = (1.0 - mask.float())[:, None, None, :] * NEG_INF
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = torch.einsum("bnqk,bknd->bqnd",
                       probs.to(torch.bfloat16).float(), vf)
    return ctx.reshape(b, t, nh * hd).to(torch.bfloat16)


def _check(q, k, v, mask):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v [B, T, heads, head_dim] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if mask.shape != q.shape[:2]:
        raise ValueError(f"mask {tuple(mask.shape)} is not [B, T] "
                         f"{tuple(q.shape[:2])}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError("q, k, v and mask must share a device")


def _launcher():
    fn = _build.load("flash_attn").flash_attn_launch
    if fn.argtypes is None:
        # Declared, or ctypes passes each pointer as a 32-bit int.
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def resident_ctas() -> int:
    """Blocks of the kernel's persistent grid the current card holds at
    once (CUDA only; builds the kernel if needed)."""
    return int(_build.load("flash_attn").flash_attn_resident_ctas())


def flash_attn(q, k, v, mask, sm_scale):
    """Launch the CUDA kernel (CUDA only)."""
    b, t, nh, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"flash_attn takes head_dim {HEAD_DIM}, got {hd}")
    if not sm_scale > 0:
        raise ValueError(f"flash_attn takes sm_scale > 0, got {sm_scale}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
        if x.stride() != q.stride():
            raise ValueError("q, k and v must share one layout")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    st = q.stride()
    if st[3] != 1 or st[2] != hd or st[0] != t * st[1] or st[1] % 8:
        raise ValueError(
            f"q, k, v need strides (T*s, s, {hd}, 1) with s % 8 == 0, got "
            f"{st}")
    mask_i = mask.to(torch.int32).contiguous()
    out = torch.empty((b, t, nh * hd), dtype=torch.bfloat16, device=q.device)
    if b * t == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_i.data_ptr(),
                 out.data_ptr(), b, t, nh, st[1], sm_scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn launch failed: cudaError {err}")
    LAUNCHES["flash_attn"] += 1
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """bf16 [B, T, heads·head_dim] attention of q, k, v [B, T, heads,
    head_dim] over the keys that ``mask`` [B, T] marks real.

    On the CPU: the plain version. On CUDA: the hand-written kernel, or
    an error — there is no fallback."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attn(q, k, v, mask, sm_scale)
