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
- ``flash_attention``: the wrapper. CPU tensors take the plain version
  (torch autograd differentiates it); CUDA tensors launch
  ``csrc/flash_attn.cu`` (head_dim 64 only; TMA, ``wgmma`` and a
  persistent grid of ``resident_ctas()`` blocks, each walking (batch
  row, head, 128-query tile) items), or raise. When grad is enabled and
  q, k or v requires it, the call goes through ``FlashAttention``: the
  forward also writes each row's log-sum-exp, and the backward
  (``flash_attn_bwd``) launches ``csrc/flash_attn_bwd.cu``'s D kernel
  (D = Σ O·dO) and its fused kernel, which computes dK, dV and dQ in one
  pass over (128-key block, head, batch row) items: the counterpart of
  both the TPU library's ``_flash_attention_bwd_dkv`` and
  ``_flash_attention_bwd_dq``. Serving (no grad) passes no LSE pointer.
- ``flash_attn_bwd_reference``: the backward kernels' own function in
  plain torch (P recomputed from the base-2 LSE), which CPU tensors take.

The TPU library kernel this replaces took the mask as segment ids,
which also masks pad QUERY rows; the key-padding form leaves those rows
as ordinary rows. Pooling drops them either way, so their output
gradient is 0 in training: pad keys then get zero dK and dV, and dQ,
dK and dV on real tokens equal the segment-id version's. A batch row
with no real key attends uniformly to its T keys, forward and backward,
as the plain version does.

The plain version rounds to the encoder's compute dtype (bf16 by
default; none when the encoder runs in f32, as the JAX ``_attend``
does); the kernels take bf16 only.
"""

from __future__ import annotations

import ctypes

import torch

from classmate_rag_tpu_torch.ops import _build
from classmate_rag_tpu_torch.utils.numerics import NEG_INF

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"flash_attn": 0, "flash_attn_bwd_delta": 0, "flash_attn_bwd": 0}

LOG2E = 1.4426950408889634

HEAD_DIM = 64   # the only head_dim csrc/flash_attn.cu takes (both E5 sizes)


def attention_reference(
    q: torch.Tensor,        # [B, T, heads, head_dim]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,     # [B, T], nonzero = real token
    sm_scale: float,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain version → [B, T, heads·head_dim] in ``dtype``, the
    encoder's compute dtype (bf16 unless it runs in f32)."""
    b, t, nh, hd = q.shape
    qf, kf, vf = (x.to(dtype).float() for x in (q, k, v))
    # Products of bf16 values are exact in f32, so the f32 einsum is the
    # reference's bf16 einsum with f32 accumulation.
    scores = torch.einsum("bqnd,bknd->bnqk", qf, kf) * sm_scale
    bias = (1.0 - mask.float())[:, None, None, :] * NEG_INF
    probs = torch.softmax(scores + bias, dim=-1)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs.to(dtype).float(), vf)
    return ctx.reshape(b, t, nh * hd).to(dtype)


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
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("flash_attn_bwd")
    if lib.flash_attn_bwd_launch.argtypes is None:
        # Declared, or ctypes passes each pointer as a 32-bit int.
        lib.flash_attn_bwd_delta_launch.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.flash_attn_bwd_launch.argtypes = [ctypes.c_void_p] * 12 + [
            ctypes.c_int] * 3 + [ctypes.c_longlong] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        for fn in (lib.flash_attn_bwd_delta_launch, lib.flash_attn_bwd_launch,
                   lib.flash_attn_bwd_resident_ctas):
            fn.restype = ctypes.c_int
    return lib


def resident_ctas() -> int:
    """Blocks of the kernel's persistent grid the current card holds at
    once (CUDA only; builds the kernel if needed)."""
    return int(_build.load("flash_attn").flash_attn_resident_ctas())


def bwd_resident_ctas() -> int:
    """Blocks of the fused backward kernel's persistent grid the current
    card holds at once (CUDA only; builds the kernel if needed)."""
    return int(_bwd_lib().flash_attn_bwd_resident_ctas())


def _check_qkv(q, k, v, sm_scale):
    """The kernels' layout: bf16 [B, T, heads, 64] views sharing strides
    (T·s, s, 64, 1) with s % 8 == 0, 16-byte aligned."""
    hd = q.shape[3]
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
    if (st[3] != 1 or st[2] != hd or st[0] != q.shape[1] * st[1]
            or st[1] % 8):
        raise ValueError(
            f"q, k, v need strides (T*s, s, {hd}, 1) with s % 8 == 0, got "
            f"{st}")


def flash_attn(q, k, v, mask, sm_scale, with_lse: bool = False):
    """Launch the CUDA kernel (CUDA only). With ``with_lse`` also
    returns each row's base-2 log-sum-exp, f32 [B, heads, T], for the
    backward."""
    _check_qkv(q, k, v, sm_scale)
    b, t, nh, hd = q.shape
    mask_i = mask.to(torch.int32).contiguous()
    out = torch.empty((b, t, nh * hd), dtype=torch.bfloat16, device=q.device)
    lse = (torch.empty((b, nh, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * t > 0:
        fn = _launcher()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     mask_i.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if with_lse else None, b, t, nh,
                     q.stride(1), sm_scale, stream)
        if err != 0:
            raise RuntimeError(f"flash_attn launch failed: cudaError {err}")
        LAUNCHES["flash_attn"] += 1
    return (out, lse) if with_lse else out


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attn_bwd_delta(out, dout, heads: int):
    """The D kernel (CUDA only): ``delta`` f32 [B, heads, T] = Σ out·dout
    over head_dim, from ``out`` and ``dout`` bf16 [B, T, heads·64]
    contiguous; and the fused kernel's f32 workspace [B, T, heads, 64]
    and int32 counters [B, heads, ceil(T / 64)], zeroed by the same
    kernel, where T spans more than one 128-key block (else both
    None)."""
    b, t, h = out.shape
    if (out.dtype != torch.bfloat16 or dout.dtype != torch.bfloat16
            or dout.shape != out.shape or h != heads * HEAD_DIM
            or not (out.is_contiguous() and dout.is_contiguous())):
        raise ValueError("out and dout must be bf16 [B, T, heads*64] "
                         "contiguous")
    dev = out.device
    delta = torch.empty((b, heads, t), dtype=torch.float32, device=dev)
    ws = count = None
    if t > 128:
        ws = torch.empty((b, t, heads, HEAD_DIM), dtype=torch.float32,
                         device=dev)
        count = torch.empty((b, heads, -(-t // 64)), dtype=torch.int32,
                            device=dev)
    if b * t == 0:
        return delta, ws, count
    with torch.cuda.device(dev):
        err = _bwd_lib().flash_attn_bwd_delta_launch(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            count.data_ptr() if count is not None else None, b, t, heads,
            _stream(out))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_delta launch failed: cudaError "
                           f"{err}")
    LAUNCHES["flash_attn_bwd_delta"] += 1
    return delta, ws, count


def flash_attn_bwd_fused(q, k, v, dout, mask, lse, delta, ws, count,
                         sm_scale):
    """dq, dk, dv (bf16 [B, T, heads, 64]) of ``flash_attn`` from the
    fused kernel (CUDA only). ``dout`` bf16 [B, T, heads·64] contiguous,
    ``mask`` int32 [B, T], ``lse`` the forward's; ``delta``, ``ws`` and
    ``count`` from ``flash_attn_bwd_delta``."""
    _check_qkv(q, k, v, sm_scale)
    b, t, nh, _hd = q.shape
    dq, dk, dv = (torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
                  for _ in range(3))
    if b * t == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = _bwd_lib().flash_attn_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            mask.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            count.data_ptr() if count is not None else None,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, nh,
            q.stride(1), dout.stride(1), dq.stride(1), sm_scale, _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
    LAUNCHES["flash_attn_bwd"] += 1
    return dq, dk, dv


def flash_attn_bwd_reference(q, k, v, out, dout, mask, lse, sm_scale):
    """The backward kernels' function in plain torch, in f32: dq, dk, dv
    [B, T, heads, head_dim] in q's dtype from the forward's output
    ``out`` and its gradient ``dout`` [B, T, heads·head_dim], the key
    mask [B, T] and the forward's base-2 log-sum-exp ``lse`` [B, heads,
    T]. P = 2^(q·k·sm_scale·log2(e) + bias − lse), with P = 0 on the pad
    keys of a row that has a real key and P = 1/T over the T keys of a
    row that has none; D = Σ out·dout in f32."""
    b, t, nh, hd = q.shape
    qf, kf, vf = (x.float() for x in (q, k, v))
    real = mask != 0
    has_key = real.any(dim=1)[:, None, None, None]
    s = torch.einsum("bqnd,bknd->bnqk", qf, kf) * (sm_scale * LOG2E)
    p = torch.exp2(s - lse.float()[..., None])
    p = torch.where(real[:, None, None, :], p, 0.0)
    p = torch.where(has_key, p, 1.0 / t)
    do = dout.float().reshape(b, t, nh, hd)
    delta = (out.float().reshape(b, t, nh, hd) * do).sum(-1)   # [B, T, nh]
    dp = torch.einsum("bqnd,bknd->bnqk", do, vf)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dv = torch.einsum("bnqk,bqnd->bknd", p, do)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, qf) * sm_scale
    dq = torch.einsum("bnqk,bknd->bqnd", ds, kf) * sm_scale
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def flash_attn_bwd(q, k, v, out, dout, mask, lse, sm_scale):
    """dq, dk, dv ([B, T, heads, 64]) of ``flash_attn`` from its output
    ``out``, the output's gradient ``dout`` [B, T, heads·64] and the
    forward's ``lse``. CPU tensors take ``flash_attn_bwd_reference``;
    CUDA tensors launch the D kernel and then the fused kernel (bf16),
    or raise."""
    if q.device.type == "cpu":
        return flash_attn_bwd_reference(q, k, v, out, dout, mask, lse,
                                        sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    nh = q.shape[2]
    mask = mask.to(torch.int32).contiguous()
    dout = dout.to(torch.bfloat16).contiguous()
    delta, ws, count = flash_attn_bwd_delta(out.contiguous(), dout, nh)
    return flash_attn_bwd_fused(q, k, v, dout, mask, lse, delta, ws, count,
                                sm_scale)


class FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernels (CUDA only)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, sm_scale):
        out, lse = flash_attn(q, k, v, mask, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd(q, k, v, out, dout, mask, lse,
                                    ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    sm_scale: float,
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """[B, T, heads·head_dim] attention of q, k, v [B, T, heads,
    head_dim] over the keys that ``mask`` [B, T] marks real, in
    ``dtype`` (the encoder's compute dtype).

    On the CPU: the plain version, rounding to ``dtype``. On CUDA: the
    hand-written kernel (and its backward kernels when a gradient is
    wanted), bf16 only, or an error — there is no fallback."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask, sm_scale, dtype=dtype)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, mask, sm_scale)
    return flash_attn(q, k, v, mask, sm_scale)
