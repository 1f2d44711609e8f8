"""Device resolution for the port's entry points.

``None`` means CUDA: the port is built for the GPU and never falls back
to the CPU on its own. Callers that want the CPU (the differential
tests) pass ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raises if CUDA was asked for and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def synchronize(device: DeviceLike) -> None:
    """Wait for the work queued on a CUDA device (the counterpart of
    JAX's ``block_until_ready``); nothing to wait for on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pin_fp32_matmul() -> None:
    """Keep float32 matmuls in full float32 on the card.

    The reference pins f32 HIGHEST precision on the MMR similarities,
    the f16 pool rescore and the exact-mode BM25 matmuls; TF32 would
    round their inputs to 10 mantissa bits and undo exactly what those
    pins protect.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
