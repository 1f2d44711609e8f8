"""The yardstick's arithmetic: published peaks of the card and the
operations and bytes a batch's work needs, whatever implements it.

Peaks are NVIDIA's data-sheet figures (dense, no sparsity), copied from
``classmate_rag_tpu_torch/utils/profiling._DEVICE_PEAKS``: bf16 tensor
FLOP/s and HBM bytes/s.
"""

from __future__ import annotations

from typing import Optional, Tuple

_PEAKS = {
    "h100-sxm": (989e12, 3.35e12),     # SXM5, 80 GB HBM3
    "h100-pcie": (756e12, 2.0e12),
    "h100-nvl": (835e12, 3.9e12),
    "h200": (989e12, 4.8e12),
}


def peaks(kind: str) -> Optional[Tuple[float, float]]:
    """(bf16 FLOP/s, HBM bytes/s) of a card by its
    ``torch.cuda.get_device_name``; None for a card not in the table."""
    name = kind.lower()
    if "h200" in name:
        return _PEAKS["h200"]
    if "h100" in name:
        for part in ("pcie", "nvl"):
            if part in name:
                return _PEAKS[f"h100-{part}"]
        return _PEAKS["h100-sxm"]
    return None


def scan_flops(b: int, n: int, d: int) -> float:
    """The dense scan: every query against every passage vector."""
    return 2.0 * b * n * d


def scan_bytes(n: int, d: int) -> float:
    """The scan reads each bf16 passage vector and its f32 mask bias once."""
    return n * d * 2.0 + n * 4.0


def least_s(flops: float, nbytes: float, peak: Tuple[float, float]) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak[0], nbytes / peak[1])


def scan_least_s(b: int, n: int, d: int, peak) -> float:
    return least_s(scan_flops(b, n, d), scan_bytes(n, d), peak)


def batch_least_s(b: int, n: int, d: int, postings: int, peak) -> float:
    """A whole hybrid batch: the dense scan, plus 5 bytes (row id and
    term frequency) for each posting entry of the batch's distinct query
    words over the rows searched, plus the rows' f32 lengths."""
    return least_s(scan_flops(b, n, d),
                   scan_bytes(n, d) + 5.0 * postings + 4.0 * n, peak)
