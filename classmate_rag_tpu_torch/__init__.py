"""PyTorch/CUDA port of ``classmate_rag_tpu``'s hybrid retrieval path.

Mirrors the JAX package's layout module by module (``index/store.py``
here is the counterpart of ``classmate_rag_tpu/index/store.py``) and
imports nothing from it: host code the port needs is kept as its own
copy. Device work is plain PyTorch on tensors; the masked dense scan is
a hand-written CUDA kernel (``ops/csrc/topk_scan.cu``).

Entry points take ``device=None``, meaning CUDA; they run on the CPU
only when the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
