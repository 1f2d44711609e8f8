"""GGUF interop: parse llama.cpp model files into the port's decoder
(copy of the JAX package's ``models/gguf.py``; numpy, plus the placement
of a loaded tree on a torch device).

The reference's model ecosystem is GGUF: every route model is a
``*.Q4_K_M.gguf`` file (rag/config.py:101-113) fetched by
rag/model_fetch.py:33-109 and opened by llama-cpp-python
(rag/generation/llama_cpp_runner.py:37-45). This module lets those files
run on the port's decode path (models/decoder.py): it reads the GGUF
container (v2/v3 header, metadata KV store, tensor table), dequantizes
the ggml quant formats that appear in the reference lineup —
F32/F16/Q8_0/Q4_0 plus the K-quants Q4_K/Q6_K that make up Q4_K_M
files — maps the ggml tensor names onto the decoder's stacked tree,
infers ``DecoderConfig`` from the metadata, and reconstructs the file's
embedded tokenizer (SentencePiece-unigram for llama-2-era models,
byte-level BPE for Llama-3/Qwen) so a GGUF is self-contained here
exactly as it is under llama.cpp.

A writer (``write_gguf``) rounds out the story: it emits valid GGUF v3
with on-write quantization, used both by the synthetic-model test
fixtures (no network egress here — the same reason the safetensors
loader is tested against synthetic checkpoints) and as an export path.

Layout facts encoded below (ggml/gguf spec, stable since GGUF v2):
  - all integers little-endian; strings are uint64 length + UTF-8 bytes;
  - tensor dims are listed fastest-varying first (ne[0] is contiguous),
    so a C-order numpy view has shape ``reversed(ne)`` — which makes a
    2-D ggml weight land as (out_features, in_features), the same
    orientation as a torch ``.weight`` (decoder.py transposes to
    [in, out]);
  - tensor data starts at the first ``general.alignment``-aligned byte
    after the tensor table, each tensor at its recorded aligned offset;
  - quant blocks run along ne[0] (rows), so ne[0] must divide the block
    size (32 for Q4_0/Q8_0, 256 for K-quants).
"""

from __future__ import annotations

import dataclasses
import struct
from collections.abc import Mapping
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"

# -- metadata value types ---------------------------------------------------
T_UINT8, T_INT8, T_UINT16, T_INT16 = 0, 1, 2, 3
T_UINT32, T_INT32, T_FLOAT32, T_BOOL = 4, 5, 6, 7
T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_BOOL: "<?",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}

# -- ggml tensor dtypes -----------------------------------------------------
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = (
    10, 11, 12, 13, 14, 15,
)
GGML_BF16 = 30

GGML_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
    GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0", GGML_Q8_1: "Q8_1",
    GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K", GGML_Q8_K: "Q8_K",
}

# (block_size_elems, block_bytes) per supported quant type.
_BLOCK = {
    GGML_F32: (1, 4),
    GGML_F16: (1, 2),
    GGML_BF16: (1, 2),
    GGML_Q4_0: (32, 18),    # f16 d + 16 nibble bytes
    GGML_Q8_0: (32, 34),    # f16 d + 32 int8
    GGML_Q4_K: (256, 144),  # f16 d, f16 dmin, 12B 6-bit scales, 128B nibbles
    GGML_Q6_K: (256, 210),  # 128B ql, 64B qh, 16B int8 scales, f16 d
}


class GGUFTensorInfo(NamedTuple):
    name: str
    shape: Tuple[int, ...]   # numpy/C-order shape (reversed ne)
    ggml_type: int
    offset: int              # relative to the data section start


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: memoryview) -> None:
        self.buf = buf
        self.pos = 0

    def scalar(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return val

    def string(self) -> str:
        n = self.scalar("<Q")
        raw = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return raw.decode("utf-8", errors="replace")

    def value(self, vtype: int) -> Any:
        if vtype == T_STRING:
            return self.string()
        if vtype == T_ARRAY:
            etype = self.scalar("<I")
            count = self.scalar("<Q")
            if etype in _SCALAR_FMT and etype != T_BOOL:
                fmt = "<" + str(count) + _SCALAR_FMT[etype][1:]
                size = struct.calcsize(fmt)
                vals = list(struct.unpack_from(fmt, self.buf, self.pos))
                self.pos += size
                return vals
            return [self.value(etype) for _ in range(count)]
        fmt = _SCALAR_FMT.get(vtype)
        if fmt is None:
            raise ValueError(f"GGUF: unknown metadata value type {vtype}")
        return self.scalar(fmt)


def read_gguf_header(
    path: str | Path,
) -> Tuple[Dict[str, Any], List[GGUFTensorInfo], int]:
    """Parse header + metadata + tensor table without touching tensor data.

    Returns (metadata, tensor_infos, data_start_byte_offset).
    """
    data = np.memmap(path, dtype=np.uint8, mode="r")
    buf = memoryview(data)
    if bytes(buf[:4]) != GGUF_MAGIC:
        raise ValueError(f"Not a GGUF file: {path}")
    r = _Reader(buf)
    r.pos = 4
    version = r.scalar("<I")
    if version < 2:
        raise ValueError(
            f"GGUF v{version} uses 32-bit counts (pre-2023 format); "
            "only v2/v3 are supported"
        )
    n_tensors = r.scalar("<Q")
    n_kv = r.scalar("<Q")
    metadata: Dict[str, Any] = {}
    for _ in range(n_kv):
        key = r.string()
        vtype = r.scalar("<I")
        metadata[key] = r.value(vtype)
    infos: List[GGUFTensorInfo] = []
    for _ in range(n_tensors):
        name = r.string()
        n_dims = r.scalar("<I")
        ne = [r.scalar("<Q") for _ in range(n_dims)]
        ggml_type = r.scalar("<I")
        offset = r.scalar("<Q")
        infos.append(
            GGUFTensorInfo(name, tuple(reversed(ne)), ggml_type, offset)
        )
    align = int(metadata.get("general.alignment", 32))
    data_start = (r.pos + align - 1) // align * align
    return metadata, infos, data_start


# -- dequantization (vectorized, one call per tensor) -----------------------

def _dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(n // 32, 18)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)   # [nb, 1]
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32)     # [nb, 32]
    return (vals * d).reshape(-1)


def _dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(n // 32, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)


def _unpack_k4_scales(scales: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """ggml get_scale_min_k4 over [nb, 12] uint8 → (sc, m) each [nb, 8]."""
    q = scales.astype(np.uint8)
    sc = np.empty(q.shape[:1] + (8,), np.float32)
    mn = np.empty_like(sc)
    for j in range(4):
        sc[:, j] = q[:, j] & 63
        mn[:, j] = q[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (q[:, j + 4] & 0x0F) | ((q[:, j - 4] >> 6) << 4)
        mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(n // 256, 144)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)      # [nb,1]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _unpack_k4_scales(blocks[:, 4:16])                        # [nb,8]
    qs = blocks[:, 16:144]                                             # [nb,128]
    # Byte chunk j (32 bytes) holds sub-blocks 2j (low nibbles) and
    # 2j+1 (high nibbles); sub-block order in the output is interleaved
    # exactly like dequantize_row_q4_K.
    q4 = np.empty((blocks.shape[0], 8, 32), np.float32)
    for j in range(4):
        chunk = qs[:, 32 * j:32 * (j + 1)]
        q4[:, 2 * j] = (chunk & 0x0F).astype(np.float32)
        q4[:, 2 * j + 1] = (chunk >> 4).astype(np.float32)
    out = (d[:, :, None] * sc[:, :, None]) * q4 - (
        dmin[:, :, None] * mn[:, :, None]
    )
    return out.reshape(-1)


def _dequant_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(n // 256, 210)
    nb = blocks.shape[0]
    ql = blocks[:, 0:128].reshape(nb, 2, 64)       # two 128-elem halves
    qh = blocks[:, 128:192].reshape(nb, 2, 32)
    sc = blocks[:, 192:208].copy().view(np.int8).reshape(nb, 2, 8)
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)  # [nb,1]
    out = np.empty((nb, 2, 128), np.float32)
    for h in range(2):  # the two n+=128 halves
        ql_h, qh_h = ql[:, h], qh[:, h]
        l32 = np.arange(32)
        is_idx = l32 // 16                          # [32] → 0 or 1
        q1 = ((ql_h[:, :32] & 0x0F) | ((qh_h & 3) << 4)).astype(np.int8) - 32
        q2 = ((ql_h[:, 32:] & 0x0F) | (((qh_h >> 2) & 3) << 4)).astype(np.int8) - 32
        q3 = ((ql_h[:, :32] >> 4) | (((qh_h >> 4) & 3) << 4)).astype(np.int8) - 32
        q4 = ((ql_h[:, 32:] >> 4) | (((qh_h >> 6) & 3) << 4)).astype(np.int8) - 32
        s = sc[:, h].astype(np.float32)             # [nb, 8]
        out[:, h, 0:32] = s[:, is_idx + 0] * q1
        out[:, h, 32:64] = s[:, is_idx + 2] * q2
        out[:, h, 64:96] = s[:, is_idx + 4] * q3
        out[:, h, 96:128] = s[:, is_idx + 6] * q4
    return (out * d[:, :, None]).reshape(-1)


def dequantize(raw: np.ndarray, ggml_type: int, shape: Tuple[int, ...]) -> np.ndarray:
    """raw uint8 bytes of one tensor → float32 ndarray of ``shape``."""
    n = int(np.prod(shape)) if shape else 1
    if ggml_type == GGML_F32:
        out = raw.copy().view(np.float32)
    elif ggml_type == GGML_F16:
        out = raw.copy().view(np.float16).astype(np.float32)
    elif ggml_type == GGML_BF16:
        u32 = raw.copy().view(np.uint16).astype(np.uint32) << 16
        out = u32.view(np.float32)
    elif ggml_type == GGML_Q4_0:
        out = _dequant_q4_0(raw, n)
    elif ggml_type == GGML_Q8_0:
        out = _dequant_q8_0(raw, n)
    elif ggml_type == GGML_Q4_K:
        out = _dequant_q4_k(raw, n)
    elif ggml_type == GGML_Q6_K:
        out = _dequant_q6_k(raw, n)
    else:
        name = GGML_TYPE_NAMES.get(ggml_type, str(ggml_type))
        raise ValueError(
            f"GGUF: unsupported ggml tensor type {name}; supported: "
            "F32, F16, BF16, Q4_0, Q8_0, Q4_K, Q6_K"
        )
    return out.reshape(shape)


def tensor_nbytes(ggml_type: int, n_elems: int) -> int:
    bs, bb = _BLOCK[ggml_type]
    if n_elems % bs:
        raise ValueError(
            f"GGUF: {n_elems} elements not divisible by block size {bs}"
        )
    return n_elems // bs * bb


class LazyGGUFTensors(Mapping):
    """Dequantize-on-access view over a GGUF's mmap'd tensor data.

    Holds host memory for ONE dequantized tensor at a time instead of the
    whole f32 tree: a real Q4_K_M 7-8B file dequantizes to ~30 GB of f32,
    and materializing every tensor in a dict before stacking (the old
    ``load_gguf`` path) doubled that. The quant bytes stay on the page
    cache via the memmap; each ``[name]`` access dequantizes fresh.
    """

    def __init__(self, path: str | Path) -> None:
        self.metadata, infos, self._data_start = read_gguf_header(path)
        self._infos: Dict[str, GGUFTensorInfo] = {i.name: i for i in infos}
        self._data = np.memmap(path, dtype=np.uint8, mode="r")

    def __getitem__(self, name: str) -> np.ndarray:
        info = self._infos[name]
        n = int(np.prod(info.shape)) if info.shape else 1
        nbytes = tensor_nbytes(info.ggml_type, n)
        start = self._data_start + info.offset
        raw = np.asarray(self._data[start:start + nbytes])
        return dequantize(raw, info.ggml_type, info.shape)

    def __iter__(self):
        return iter(self._infos)

    def __len__(self) -> int:
        return len(self._infos)

    def f32_nbytes(self) -> int:
        """Size of the fully dequantized f32 tree (load-planning)."""
        return sum(
            4 * (int(np.prod(i.shape)) if i.shape else 1)
            for i in self._infos.values()
        )


def load_gguf(path: str | Path) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Read a GGUF file fully: (metadata, {tensor name → f32 ndarray}).

    Eager — fine for test fixtures and small models; use
    :class:`LazyGGUFTensors` for anything whose f32 tree is large.
    """
    lazy = LazyGGUFTensors(path)
    return lazy.metadata, {name: lazy[name] for name in lazy}


# ---------------------------------------------------------------------------
# Writing (fixtures + export)
# ---------------------------------------------------------------------------

def _quantize_q8_0(w: np.ndarray) -> np.ndarray:
    flat = w.astype(np.float32).reshape(-1, 32)
    amax = np.abs(flat).max(axis=1, keepdims=True)
    d = np.maximum(amax, 1e-30) / 127.0
    q = np.clip(np.round(flat / d), -127, 127).astype(np.int8)
    out = np.empty((flat.shape[0], 34), np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def _quantize_q4_0(w: np.ndarray) -> np.ndarray:
    flat = w.astype(np.float32).reshape(-1, 32)
    # ggml picks d from the max-|x| element, keeping its sign, so that
    # value maps exactly to -8 or +7.
    idx = np.abs(flat).argmax(axis=1)
    maxv = flat[np.arange(flat.shape[0]), idx]
    d = np.where(np.abs(maxv) < 1e-30, 1e-30, maxv / -8.0)
    q = np.clip(np.round(flat / d[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.empty((flat.shape[0], 18), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def _pack_k4_scales(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_k4_scales: [nb, 8] 6-bit values → [nb, 12] bytes."""
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    out = np.zeros(sc.shape[:1] + (12,), np.uint8)
    for j in range(4):
        out[:, j] = (sc[:, j] & 63) | ((sc[:, j + 4] >> 4) << 6)
        out[:, j + 4] = (mn[:, j] & 63) | ((mn[:, j + 4] >> 4) << 6)
        out[:, j + 8] = (sc[:, j + 4] & 0x0F) | ((mn[:, j + 4] & 0x0F) << 4)
    return out


def _quantize_q4_k(w: np.ndarray) -> np.ndarray:
    """Simple (max/min based, not llama.cpp's search) — valid encoding."""
    flat = w.astype(np.float32).reshape(-1, 8, 32)
    vmin = np.minimum(flat.min(axis=2), 0.0)            # [nb, 8]
    vmax = flat.max(axis=2)
    f = np.maximum((vmax - vmin) / 15.0, 1e-30)         # per-sub scale
    mf = -vmin                                          # ≥ 0
    d = np.maximum(f.max(axis=1, keepdims=True) / 63.0, 1e-30)
    dmin = np.maximum(mf.max(axis=1, keepdims=True) / 63.0, 1e-30)
    sc = np.clip(np.round(f / d), 0, 63)
    mn = np.clip(np.round(mf / dmin), 0, 63)
    eff_f = d * sc                                      # [nb, 8]
    eff_m = dmin * mn
    q = np.clip(
        np.round((flat + eff_m[:, :, None]) / np.maximum(eff_f, 1e-30)[:, :, None]),
        0, 15,
    ).astype(np.uint8)
    nb = flat.shape[0]
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = d.astype(np.float16).view(np.uint8)
    out[:, 2:4] = dmin.astype(np.float16).view(np.uint8)
    out[:, 4:16] = _pack_k4_scales(sc, mn)
    for j in range(4):
        out[:, 16 + 32 * j:16 + 32 * (j + 1)] = q[:, 2 * j] | (q[:, 2 * j + 1] << 4)
    return out.reshape(-1)


def _quantize_q6_k(w: np.ndarray) -> np.ndarray:
    flat = w.astype(np.float32).reshape(-1, 16, 16)     # 16 sub-blocks of 16
    amax = np.abs(flat).max(axis=2)                     # [nb, 16]
    f = np.maximum(amax / 31.0, 1e-30)
    d = np.maximum(f.max(axis=1, keepdims=True) / 127.0, 1e-30)   # [nb, 1]
    sc = np.clip(np.round(f / d), 1, 127)               # int8 ≥ 1
    eff = d * sc
    q = np.clip(np.round(flat / eff[:, :, None]) + 32, 0, 63).astype(np.uint8)
    nb = flat.shape[0]
    q = q.reshape(nb, 2, 128)                           # the two halves
    out = np.empty((nb, 210), np.uint8)
    for h in range(2):
        qh_block = q[:, h]
        lo1, lo2 = qh_block[:, :32] & 0x0F, qh_block[:, 32:64] & 0x0F
        lo3, lo4 = qh_block[:, 64:96] & 0x0F, qh_block[:, 96:128] & 0x0F
        hi1, hi2 = qh_block[:, :32] >> 4, qh_block[:, 32:64] >> 4
        hi3, hi4 = qh_block[:, 64:96] >> 4, qh_block[:, 96:128] >> 4
        base = 64 * h
        out[:, base:base + 32] = lo1 | (lo3 << 4)
        out[:, base + 32:base + 64] = lo2 | (lo4 << 4)
        hbase = 128 + 32 * h
        out[:, hbase:hbase + 32] = hi1 | (hi2 << 2) | (hi3 << 4) | (hi4 << 6)
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = d.astype(np.float16).view(np.uint8)
    return out.reshape(-1)


_QUANTIZERS = {
    GGML_Q8_0: _quantize_q8_0,
    GGML_Q4_0: _quantize_q4_0,
    GGML_Q4_K: _quantize_q4_k,
    GGML_Q6_K: _quantize_q6_k,
}


def _encode_value(out: bytearray, vtype: int, val: Any) -> None:
    if vtype == T_STRING:
        raw = str(val).encode("utf-8")
        out += struct.pack("<Q", len(raw)) + raw
    elif vtype == T_ARRAY:
        etype, elems = val
        out += struct.pack("<IQ", etype, len(elems))
        for e in elems:
            _encode_value(out, etype, e)
    else:
        out += struct.pack(_SCALAR_FMT[vtype], val)


def _infer_vtype(val: Any) -> Tuple[int, Any]:
    if isinstance(val, bool):
        return T_BOOL, val
    if isinstance(val, int):
        return (T_INT64, val) if val < 0 else (T_UINT32 if val < 2**32 else T_UINT64, val)
    if isinstance(val, float):
        return T_FLOAT32, val
    if isinstance(val, str):
        return T_STRING, val
    if isinstance(val, (list, tuple)):
        if not val:
            return T_ARRAY, (T_STRING, [])
        etype, _ = _infer_vtype(val[0])
        if etype == T_UINT32 and any(
            isinstance(e, int) and e < 0 for e in val
        ):
            etype = T_INT32
        return T_ARRAY, (etype, list(val))
    raise TypeError(f"GGUF write: cannot encode metadata value {val!r}")


def write_gguf(
    path: str | Path,
    metadata: Dict[str, Any],
    tensors: Dict[str, np.ndarray],
    quant_types: Optional[Dict[str, int]] = None,
    default_type: int = GGML_F32,
    alignment: int = 32,
) -> None:
    """Write a GGUF v3 file; per-tensor ggml types via ``quant_types``.

    Metadata values are plain Python scalars/strings/lists (types
    inferred); pass an explicit ``(vtype, value)`` tuple to force one.
    """
    quant_types = quant_types or {}
    # Build the final KV dict BEFORE declaring its count: setdefault adds
    # nothing when the caller's metadata already carries the alignment
    # key, and an over-declared count corrupts the file (the reader would
    # parse the first tensor-table entry as a metadata KV).
    meta = dict(metadata)
    meta.setdefault("general.alignment", alignment)
    # Pad with the alignment the header DECLARES (a caller-supplied
    # metadata value wins over the keyword), or readers mis-seek.
    decl = meta["general.alignment"]
    alignment = int(decl[1] if isinstance(decl, tuple) else decl)
    header = bytearray()
    header += GGUF_MAGIC + struct.pack("<IQQ", 3, len(tensors), len(meta))
    for key, val in meta.items():
        raw_key = key.encode("utf-8")
        header += struct.pack("<Q", len(raw_key)) + raw_key
        if isinstance(val, tuple) and len(val) == 2 and isinstance(val[0], int):
            vtype, payload = val
        else:
            vtype, payload = _infer_vtype(val)
        header += struct.pack("<I", vtype)
        _encode_value(header, vtype, payload)

    blobs: List[np.ndarray] = []
    offset = 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        gtype = quant_types.get(name, default_type)
        if arr.ndim and arr.shape[-1] % _BLOCK[gtype][0]:
            gtype = GGML_F32  # norms/biases too narrow for the block quant
        if gtype == GGML_F32:
            blob = arr.astype(np.float32).reshape(-1).view(np.uint8)
        elif gtype == GGML_F16:
            blob = arr.astype(np.float16).reshape(-1).view(np.uint8)
        elif gtype in _QUANTIZERS:
            blob = _QUANTIZERS[gtype](arr)
        else:
            raise ValueError(
                f"GGUF write: unsupported type {GGML_TYPE_NAMES.get(gtype)}"
            )
        raw_name = name.encode("utf-8")
        header += struct.pack("<Q", len(raw_name)) + raw_name
        ne = list(reversed(arr.shape))
        header += struct.pack("<I", len(ne))
        for dim in ne:
            header += struct.pack("<Q", dim)
        header += struct.pack("<IQ", gtype, offset)
        blobs.append(np.asarray(blob, np.uint8))
        size = blob.nbytes
        offset += (size + alignment - 1) // alignment * alignment

    data_start = (len(header) + alignment - 1) // alignment * alignment
    with open(path, "wb") as f:
        f.write(header)
        f.write(b"\x00" * (data_start - len(header)))
        written = 0
        for blob in blobs:
            f.write(blob.tobytes())
            written += blob.nbytes
            pad = -written % alignment
            f.write(b"\x00" * pad)
            written += pad


# ---------------------------------------------------------------------------
# DecoderConfig + params from a GGUF model
# ---------------------------------------------------------------------------

def config_from_gguf(metadata: Dict[str, Any]):
    """Infer ``DecoderConfig`` from GGUF metadata.

    Reads the ``{arch}.*`` keys llama.cpp itself reads (llm_load_hparams):
    embedding_length, block_count, attention.head_count[_kv],
    feed_forward_length, context_length, rope.freq_base,
    attention.layer_norm_rms_epsilon, attention.key_length.
    """
    from classmate_rag_tpu_torch.models.decoder import DecoderConfig

    arch = str(metadata.get("general.architecture", "llama"))
    def g(key: str, default=None):
        return metadata.get(f"{arch}.{key}", default)

    def f32_clean(x: float) -> float:
        # Floats ride GGUF as f32; round to f32's 7 significant digits so
        # eps values like 1e-5 come back as the canonical python float.
        return float(f"{float(x):.7g}")

    heads = int(g("attention.head_count", 32))
    vocab = metadata.get("tokenizer.ggml.tokens")
    if vocab is not None:
        vocab_size = len(vocab)
    else:
        vocab_size = int(g("vocab_size", 32000))
    key_length = g("attention.key_length")
    hidden = int(g("embedding_length", 4096))
    return DecoderConfig(
        vocab_size=vocab_size,
        hidden=hidden,
        layers=int(g("block_count", 32)),
        heads=heads,
        kv_heads=int(g("attention.head_count_kv", heads)),
        ffn=int(g("feed_forward_length", 4 * hidden)),
        max_seq=int(g("context_length", 8192)),
        rope_theta=f32_clean(g("rope.freq_base", 10000.0)),
        norm_eps=f32_clean(g("attention.layer_norm_rms_epsilon", 1e-5)),
        # Qwen2 GGUFs carry attn_q.bias tensors; flag set by the caller
        # that sees the tensor table (load_params_from_gguf) — from
        # metadata alone, follow the architecture.
        qkv_bias=arch == "qwen2",
        qk_norm=arch == "qwen3",
        head_dim_override=int(key_length) if key_length else None,
    )


def load_params_from_gguf(
    path: str | Path,
    config=None,
    *,
    host: bool = False,
    dtype=None,
    device=None,
):
    """Read a GGUF model into (DecoderConfig, stacked decoder Params).

    The ggml name map mirrors llama.cpp's TENSOR_NAMES for the llama/
    qwen2/qwen3 architectures; 2-D weights arrive (out, in) (see module
    docstring) and transpose to the decoder's [in, out] orientation —
    the same step the HF safetensors loader performs
    (decoder.load_params_from_hf).

    Memory posture for real 7-8B files: tensors dequantize one at a time
    off the memmap (:class:`LazyGGUFTensors`), ``dtype=None`` auto-drops
    host storage to float16 once the f32 tree would exceed ~4 GB (f16
    carries more mantissa than the bf16 the forward computes in, so
    nothing is lost), and ``host=True`` keeps the tree in numpy so the
    caller can quantize host-side (decoder.quantize_decoder_params_host)
    before anything crosses to the card. Otherwise the tree is placed on
    ``device`` (None → CUDA) by ``decoder.params_from_numpy``.
    """
    tensors = LazyGGUFTensors(path)
    metadata = tensors.metadata
    if dtype is None:
        dtype = (
            np.float16 if tensors.f32_nbytes() > (4 << 30) else np.float32
        )
    if config is None:
        config = config_from_gguf(metadata)
        if "blk.0.attn_q.bias" in tensors:
            config = dataclasses.replace(config, qkv_bias=True)
        if "blk.0.attn_q_norm.weight" in tensors:
            config = dataclasses.replace(config, qk_norm=True)

    def get(name: str) -> np.ndarray:
        if name not in tensors:
            raise KeyError(name)
        return np.asarray(tensors[name], dtype=dtype)

    L = config.layers
    keys = ["attn_norm", "q_w", "k_w", "v_w", "o_w",
            "ffn_norm", "gate_w", "up_w", "down_w"]
    if config.qkv_bias:
        keys += ["q_b", "k_b", "v_b"]
    if config.qk_norm:
        keys += ["q_norm", "k_norm"]
    stacks: Dict[str, list] = {k: [] for k in keys}
    try:
        for i in range(L):
            base = f"blk.{i}."
            stacks["attn_norm"].append(get(base + "attn_norm.weight"))
            stacks["q_w"].append(get(base + "attn_q.weight").T)
            stacks["k_w"].append(get(base + "attn_k.weight").T)
            stacks["v_w"].append(get(base + "attn_v.weight").T)
            stacks["o_w"].append(get(base + "attn_output.weight").T)
            if config.qkv_bias:
                stacks["q_b"].append(get(base + "attn_q.bias"))
                stacks["k_b"].append(get(base + "attn_k.bias"))
                stacks["v_b"].append(get(base + "attn_v.bias"))
            if config.qk_norm:
                stacks["q_norm"].append(get(base + "attn_q_norm.weight"))
                stacks["k_norm"].append(get(base + "attn_k_norm.weight"))
            stacks["ffn_norm"].append(get(base + "ffn_norm.weight"))
            stacks["gate_w"].append(get(base + "ffn_gate.weight").T)
            stacks["up_w"].append(get(base + "ffn_up.weight").T)
            stacks["down_w"].append(get(base + "ffn_down.weight").T)
        tok_emb = get("token_embd.weight")
        if "output.weight" in tensors:
            lm_head = get("output.weight").T
        else:
            lm_head = tok_emb.T  # tied embeddings (Qwen2-small, Gemma style)
        params = {
            "tok_emb": tok_emb,
            "final_norm": get("output_norm.weight"),
            "lm_head": lm_head,
            "layers": {k: np.stack(v) for k, v in stacks.items()},
        }
    except KeyError as exc:
        raise ValueError(
            f"GGUF {path}: missing tensor {exc} for a "
            f"{config.layers}-layer llama-family model"
        ) from None
    if params["tok_emb"].shape != (config.vocab_size, config.hidden):
        raise ValueError(
            f"GGUF {path}: token_embd shape {params['tok_emb'].shape} != "
            f"({config.vocab_size}, {config.hidden})"
        )
    if host:
        return config, params
    from classmate_rag_tpu_torch.models.decoder import params_from_numpy

    return config, params_from_numpy(params, config, device)


def decoder_params_to_gguf_tensors(params, config) -> Dict[str, np.ndarray]:
    """Stacked decoder Params → flat ggml-named tensor dict (inverse of
    load_params_from_gguf; used by the synthetic fixtures and as export)."""
    def np32(x):
        if hasattr(x, "detach"):                 # a torch tensor
            x = x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)

    out: Dict[str, np.ndarray] = {
        "token_embd.weight": np32(params["tok_emb"]),
        "output_norm.weight": np32(params["final_norm"]),
        "output.weight": np32(params["lm_head"]).T,
    }
    lp = params["layers"]
    name_map = [
        ("attn_norm.weight", "attn_norm", False),
        ("attn_q.weight", "q_w", True),
        ("attn_k.weight", "k_w", True),
        ("attn_v.weight", "v_w", True),
        ("attn_output.weight", "o_w", True),
        ("ffn_norm.weight", "ffn_norm", False),
        ("ffn_gate.weight", "gate_w", True),
        ("ffn_up.weight", "up_w", True),
        ("ffn_down.weight", "down_w", True),
    ]
    if config.qkv_bias:
        name_map += [("attn_q.bias", "q_b", False),
                     ("attn_k.bias", "k_b", False),
                     ("attn_v.bias", "v_b", False)]
    if config.qk_norm:
        name_map += [("attn_q_norm.weight", "q_norm", False),
                     ("attn_k_norm.weight", "k_norm", False)]
    for i in range(config.layers):
        for gname, key, transpose in name_map:
            w = np32(lp[key][i])
            out[f"blk.{i}.{gname}"] = w.T if transpose else w
    return out


def gguf_metadata_for_config(
    config, arch: str = "llama", tokens: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Minimal llama.cpp-readable metadata block for ``config``."""
    md: Dict[str, Any] = {
        "general.architecture": arch,
        f"{arch}.embedding_length": config.hidden,
        f"{arch}.block_count": config.layers,
        f"{arch}.attention.head_count": config.heads,
        f"{arch}.attention.head_count_kv": config.kv_heads,
        f"{arch}.feed_forward_length": config.ffn,
        f"{arch}.context_length": config.max_seq,
        f"{arch}.rope.freq_base": float(config.rope_theta),
        f"{arch}.attention.layer_norm_rms_epsilon": float(config.norm_eps),
        f"{arch}.vocab_size": config.vocab_size,
    }
    if config.head_dim_override:
        md[f"{arch}.attention.key_length"] = config.head_dim_override
        md[f"{arch}.attention.value_length"] = config.head_dim_override
    if tokens is not None:
        md["tokenizer.ggml.tokens"] = (T_ARRAY, (T_STRING, list(tokens)))
    return md


def export_decoder_to_gguf(
    path: str | Path,
    params,
    config,
    arch: str = "llama",
    quant_type: int = GGML_F32,
    extra_metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a decoder params tree (numpy or tensors) as a
    llama.cpp-loadable GGUF file.

    ``quant_type`` applies to the 2-D matmul weights; norms and biases
    stay F32 (write_gguf demotes any tensor whose last dim doesn't
    divide the quant block size)."""
    tensors = decoder_params_to_gguf_tensors(params, config)
    metadata = gguf_metadata_for_config(config, arch=arch)
    if extra_metadata:
        metadata.update(extra_metadata)
    quant_map = {
        name: quant_type for name, arr in tensors.items() if arr.ndim == 2
    }
    write_gguf(path, metadata, tensors, quant_types=quant_map)


# ---------------------------------------------------------------------------
# Embedded tokenizer
# ---------------------------------------------------------------------------

def _gpt2_byte_decoder() -> Dict[str, int]:
    """The GPT-2 printable-byte bijection (unicode char → raw byte)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class GGUFTokenizer:
    """Tokenizer reconstructed from GGUF ``tokenizer.ggml.*`` metadata.

    Two vocab models cover the reference lineup
    (rag/config.py:101-113):

    - ``llama``: SentencePiece-unigram — encode by Viterbi over piece
      scores (exactly SP's algorithm for a pure unigram model), byte
      fallback to the ``<0xNN>`` pieces, "▁" as the space marker;
    - ``gpt2``: byte-level BPE (Llama-3, Qwen2/3) — the GPT-2 byte
      bijection plus rank-ordered merges from ``tokenizer.ggml.merges``.

    The surface matches HFTokenizer where the decode path uses it:
    ``encode_raw`` (no framing, tail-keeping truncation) and ``decode``.
    """

    def __init__(self, metadata: Dict[str, Any], max_length: int = 1024) -> None:
        self.model = str(metadata.get("tokenizer.ggml.model", "llama"))
        self.tokens: List[str] = list(metadata.get("tokenizer.ggml.tokens", []))
        self.scores: List[float] = list(
            metadata.get("tokenizer.ggml.scores", []) or []
        )
        self.token_types: List[int] = list(
            metadata.get("tokenizer.ggml.token_type", []) or []
        )
        self.vocab_size = len(self.tokens)
        self.max_length = max_length
        bos = metadata.get("tokenizer.ggml.bos_token_id")
        # No invented BOS: only SPM (llama) models get the conventional
        # id 1 default; a BPE file without the key has no BOS to prepend
        # (id 1 there is an arbitrary vocab entry).
        if bos is None and self.model == "llama":
            bos = 1
        self.bos_id: Optional[int] = int(bos) if bos is not None else None
        self.eos_id = int(metadata.get("tokenizer.ggml.eos_token_id", 2))
        self.unk_id = int(metadata.get("tokenizer.ggml.unknown_token_id", 0))
        # llama.cpp's tokenizer_add_bos: explicit flag wins; defaults are
        # per vocab model (SPM prepends BOS, byte-BPE does not) — Llama-3
        # GGUFs carry add_bos_token=true, Qwen2/3 carry false/absent.
        add_bos = metadata.get("tokenizer.ggml.add_bos_token")
        if add_bos is None:
            add_bos = self.model == "llama"
        self.add_bos = bool(add_bos) and self.bos_id is not None
        self._piece_ids: Dict[str, int] = {}
        for i, t in enumerate(self.tokens):
            self._piece_ids.setdefault(t, i)
        # type 6 = BYTE pieces ("<0xNN>") for SP byte-fallback.
        self._byte_ids: Dict[int, int] = {}
        for i, t in enumerate(self.tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                try:
                    self._byte_ids[int(t[3:5], 16)] = i
                except ValueError:
                    pass
        if self.model == "gpt2":
            self._byte_dec = _gpt2_byte_decoder()
            self._byte_enc = {b: c for c, b in self._byte_dec.items()}
            merges = metadata.get("tokenizer.ggml.merges", []) or []
            self._ranks = {tuple(m.split(" ", 1)): r for r, m in enumerate(merges)}

    # -- unigram (SentencePiece) -------------------------------------------
    def _encode_unigram(self, text: str) -> List[int]:
        if not text:
            # SentencePiece adds the dummy prefix only to non-empty
            # input: sp.encode("") is [] (llama.cpp: just BOS).
            return []
        text = "▁" + text.replace(" ", "▁")
        n = len(text)
        NEG = -1e30
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        max_piece = 24
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            matched = False
            for j in range(i + 1, min(n, i + max_piece) + 1):
                pid = self._piece_ids.get(text[i:j])
                if pid is None:
                    continue
                matched = True
                s = best[i] + (self.scores[pid] if pid < len(self.scores) else 0.0)
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, pid)
            if not matched:
                # byte fallback: encode this char's UTF-8 bytes.
                raw = text[i].encode("utf-8")
                s = best[i] - 20.0 * len(raw)
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, -1)
        ids: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos] or (pos - 1, -1)
            if pid >= 0:
                ids.append(pid)
            else:
                for b in reversed(text[prev:pos].encode("utf-8")):
                    ids.append(self._byte_ids.get(b, self.unk_id))
            pos = prev
        return list(reversed(ids))

    # -- byte-level BPE -----------------------------------------------------
    def _bpe_word(self, word: str) -> List[str]:
        parts = list(word)
        while len(parts) > 1:
            pairs = [
                (self._ranks.get((parts[i], parts[i + 1]), 1 << 30), i)
                for i in range(len(parts) - 1)
            ]
            rank, i = min(pairs)
            if rank >= 1 << 30:
                break
            parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
        return parts

    def _encode_bpe(self, text: str) -> List[int]:
        import re

        # GPT-2's pretokenizer regex with \p{L} ≈ [^\W\d_] and \p{N} ≈ \d.
        # The "other" class must be [^\s\p{L}\p{N}] — NOT [^\s\w]: "_" is
        # \w but neither letter nor digit, so a bare [^\s\w] class would
        # match no alternative and findall would silently DELETE
        # underscores from the text (snake_case identifiers are common in
        # course material). (?:[^\s\w]|_) restores it to the punct class,
        # exactly where llama.cpp's \p-based pattern puts it.
        pat = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d"
            r"| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+",
            re.UNICODE,
        )
        ids: List[int] = []
        for piece in pat.findall(text):
            mapped = "".join(self._byte_enc[b] for b in piece.encode("utf-8"))
            for part in self._bpe_word(mapped):
                pid = self._piece_ids.get(part)
                if pid is not None:
                    ids.append(pid)
                else:
                    ids.extend(
                        self._piece_ids.get(ch, self.unk_id) for ch in part
                    )
        return ids

    # -- public surface -----------------------------------------------------
    def encode_raw(self, text: str, max_length: Optional[int] = None) -> List[int]:
        limit = max_length or self.max_length
        if self.model == "gpt2":
            ids = self._encode_bpe(text or "")
        else:
            ids = self._encode_unigram(text or "")
        if self.add_bos:
            ids = [self.bos_id] + ids
        return ids[-limit:]

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        return self.encode_raw(text, max_length)

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> List[List[int]]:
        return [self.encode_raw(t, max_length) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        control = {self.bos_id, self.eos_id}
        if self.model == "gpt2":
            raw = bytearray()
            for i in ids:
                if i in control or not (0 <= i < self.vocab_size):
                    continue
                for ch in self.tokens[i]:
                    raw.append(self._byte_dec.get(ch, ord("?") if ord(ch) > 255 else ord(ch)))
            return raw.decode("utf-8", errors="replace")
        raw = bytearray()
        for i in ids:
            if i in control or not (0 <= i < self.vocab_size):
                continue
            piece = self.tokens[i]
            if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
                try:
                    raw.append(int(piece[3:5], 16))
                    continue
                except ValueError:
                    pass
            raw += piece.encode("utf-8")
        # SP replaces the space marker AFTER concatenation, so "▁" arriving
        # via byte-fallback pieces becomes a space too.
        text = raw.decode("utf-8", errors="replace").replace("▁", " ")
        return text[1:] if text.startswith(" ") else text
