"""Fused encoder epilogues: bias+GELU and residual+bias+LayerNorm (port of
the JAX package's ``ops/encoder_fused.py``).

- ``bias_gelu``: exact GELU of (y + b), written in bf16, the next
  matmul's operand type; one pass over the [B·T, 4H] activations.
- ``residual_ln``: LayerNorm(resid + (y + b))·g + beta over rows, biased
  variance; one pass over the [B·T, H] stream.

Each has a plain PyTorch version (``*_reference``: the encoder's unfused
math, which is what the JAX package computes off the TPU) and a CUDA
kernel (``csrc/bias_gelu.cu``, ``csrc/residual_ln.cu``). The wrappers take
the plain version for CPU tensors and launch the kernel, or raise, for
CUDA tensors.

The kernels have no backward, as the JAX package's Pallas kernels have
none (``jax.grad`` through them fails to linearize). A CUDA call that
would need a gradient raises rather than hand back an output detached
from the graph: training runs with ``fused_epilogue=False``.
"""

from __future__ import annotations

import ctypes

import torch

from classmate_rag_tpu_torch.ops import _build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"bias_gelu": 0, "residual_ln": 0}

# sqrt(0.5); multiplied into an f32 tensor it rounds as the JAX gelu's.
_SQRT_HALF = 0.7071067811865476
_MAX_LN_WIDTH = 1024   # csrc/residual_ln.cu keeps a row in registers


def fusable(n_rows: int, width: int) -> bool:
    """Static gate of the fused epilogues (the JAX package's, unchanged)."""
    return width % 128 == 0 and n_rows % 8 == 0


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The encoder's ``_layer_norm``: f32, two-pass biased variance."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def bias_gelu_reference(y: torch.Tensor, b: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Plain version: ``jax.nn.gelu(y + b, approximate=False)`` in f32
    (0.5·x·erfc(−x/√2)), rounded to ``out_dtype`` (the encoder's compute
    dtype; the kernel writes bf16)."""
    x = y + b
    return (0.5 * x * torch.erfc(-x * _SQRT_HALF)).to(out_dtype)


def residual_ln_reference(resid, y, b, g, beta, eps: float) -> torch.Tensor:
    """Plain version: LayerNorm(resid + (y + b)), the unfused path's
    association (``attn_out = mm + b; hidden + attn_out``)."""
    return layer_norm(resid + (y + b), g, beta, eps)


def _launcher(name: str, n_ptr: int, tail: list):
    """``<name>_launch`` of ``csrc/<name>.cu``, built if missing."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        # Declared, or ctypes passes each pointer as a 32-bit int.
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


def _no_grad_wanted(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (the JAX package's "
            f"Pallas kernel has none either), so it cannot run where a "
            f"gradient is wanted; train with fused_epilogue=False")


def _same_device(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs must share a device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def bias_gelu(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 [N, F] = gelu(y [N, F] f32 + b [F] f32).

    On the CPU: the plain version. On CUDA: the hand-written kernel, or
    an error — there is no fallback."""
    if y.dim() != 2 or b.shape != (y.shape[1],):
        raise ValueError(f"bias_gelu: y {tuple(y.shape)}, b {tuple(b.shape)}")
    if _same_device("bias_gelu", y, b).type == "cpu":
        return bias_gelu_reference(y, b)
    _no_grad_wanted("bias_gelu", y, b)
    _check_cuda("bias_gelu", y, b)
    n, f = y.shape
    if f % 8:
        raise ValueError(f"bias_gelu: width must be a multiple of 8, got {f}")
    out = torch.empty((n, f), dtype=torch.bfloat16, device=y.device)
    if n * f == 0:
        return out
    fn = _launcher("bias_gelu", 3, [ctypes.c_longlong, ctypes.c_int])
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), b.data_ptr(), out.data_ptr(), n, f, stream)
    if err != 0:
        raise RuntimeError(f"bias_gelu launch failed: cudaError {err}")
    LAUNCHES["bias_gelu"] += 1
    return out


def residual_ln(
    resid: torch.Tensor,   # [N, H] f32 (stream into the layer)
    y: torch.Tensor,       # [N, H] f32 (matmul output)
    b: torch.Tensor,       # [H] f32 (matmul bias)
    g: torch.Tensor,       # [H] f32 (LN gain)
    beta: torch.Tensor,    # [H] f32 (LN shift)
    eps: float,
) -> torch.Tensor:
    """f32 [N, H] = LayerNorm(resid + (y + b))·g + beta.

    On the CPU: the plain version. On CUDA: the hand-written kernel, or
    an error — there is no fallback."""
    if resid.dim() != 2 or y.shape != resid.shape or any(
            v.shape != (resid.shape[1],) for v in (b, g, beta)):
        raise ValueError(f"residual_ln: shapes {tuple(resid.shape)}, "
                         f"{tuple(y.shape)}, {tuple(b.shape)}")
    if _same_device("residual_ln", resid, y, b, g, beta).type == "cpu":
        return residual_ln_reference(resid, y, b, g, beta, eps)
    _no_grad_wanted("residual_ln", resid, y, b, g, beta)
    _check_cuda("residual_ln", resid, y, b, g, beta)
    n, h = resid.shape
    if h % 128 or h > _MAX_LN_WIDTH:
        raise ValueError(
            f"residual_ln: width must be a multiple of 128 up to "
            f"{_MAX_LN_WIDTH}, got {h}")
    out = torch.empty_like(resid)
    if n == 0:
        return out
    fn = _launcher("residual_ln", 6,
                   [ctypes.c_int, ctypes.c_int, ctypes.c_float])
    with torch.cuda.device(resid.device):
        stream = torch.cuda.current_stream(resid.device).cuda_stream
        err = fn(resid.data_ptr(), y.data_ptr(), b.data_ptr(), g.data_ptr(),
                 beta.data_ptr(), out.data_ptr(), n, h, eps, stream)
    if err != 0:
        raise RuntimeError(f"residual_ln launch failed: cudaError {err}")
    LAUNCHES["residual_ln"] += 1
    return out
