"""Tokenization for the E5 encoder (copy of the JAX package's
``embeddings/tokenizer.py``; numpy-only, the same ids byte for byte).

Two tiers:

1. ``HFTokenizer`` — wraps a ``tokenizers.Tokenizer`` loaded from a local
   ``tokenizer.json`` (the standard file in an E5/XLM-R snapshot). Used
   whenever real model weights are available; ``tokenizers`` is imported
   only then.
2. ``HashTokenizer`` — a deterministic, dependency-free fallback for
   offline environments: unicode word/punctuation split, each token hashed
   into the XLM-R id space. It keeps the *shape* of the pipeline (special
   tokens, padding, truncation), so every downstream component runs the
   same code paths with or without weights.

XLM-R conventions: <s>=0, <pad>=1, </s>=2, <unk>=3; vocab 250002.
"""

from __future__ import annotations

import re
from hashlib import blake2b
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

BOS_ID = 0
PAD_ID = 1
EOS_ID = 2
UNK_ID = 3
XLMR_VOCAB = 250002

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class HashTokenizer:
    """Deterministic hashing tokenizer (offline fallback)."""

    def __init__(self, vocab_size: int = XLMR_VOCAB, max_length: int = 512) -> None:
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._reserved = 100  # ids below this are special/reserved

    def _token_id(self, token: str) -> int:
        digest = blake2b(token.encode("utf-8"), digest_size=8).digest()
        span = self.vocab_size - self._reserved
        return self._reserved + int.from_bytes(digest, "little") % span

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        limit = max_length or self.max_length
        toks = _WORD_RE.findall((text or "").lower())
        ids = [BOS_ID] + [self._token_id(t) for t in toks[: limit - 2]] + [EOS_ID]
        return ids

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> List[List[int]]:
        return [self.encode(t, max_length) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        """Hashing is one-way; decoding yields placeholder token markers."""
        return " ".join(f"<tok{i}>" for i in ids if i not in (BOS_ID, PAD_ID, EOS_ID))


class HFTokenizer:
    """tokenizer.json-backed tokenizer (requires the `tokenizers` package).

    ``encode``/``encode_batch`` wrap ids in the XLM-R <s>…</s> frame the
    E5 encoder expects; decoder checkpoints (LLaMA-family) must NOT get
    that frame — their tokenizer.json already applies its own template —
    so they use ``encode_raw``.
    """

    def __init__(self, tokenizer_file: Path, max_length: int = 512) -> None:
        from tokenizers import Tokenizer  # local import: optional dep

        self._tok = Tokenizer.from_file(str(tokenizer_file))
        self.max_length = max_length
        self.vocab_size = self._tok.get_vocab_size()

    def encode_raw(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """Tokenizer-template encoding, no XLM-R framing; keeps the TAIL
        on truncation (decoder prompts lose their oldest context first)."""
        limit = max_length or self.max_length
        ids = self._tok.encode(text or "").ids
        return ids[-limit:]

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        limit = max_length or self.max_length
        ids = self._tok.encode(text or "").ids
        if not ids or ids[0] != BOS_ID:
            ids = [BOS_ID] + ids
        if ids[-1] != EOS_ID:
            ids = ids + [EOS_ID]
        if len(ids) > limit:
            ids = ids[: limit - 1] + [EOS_ID]
        return ids

    def encode_batch(
        self, texts: Sequence[str], max_length: Optional[int] = None
    ) -> List[List[int]]:
        limit = max_length or self.max_length
        encs = self._tok.encode_batch([t or "" for t in texts])
        out: List[List[int]] = []
        for e in encs:
            ids = e.ids
            if not ids or ids[0] != BOS_ID:
                ids = [BOS_ID] + ids
            if ids[-1] != EOS_ID:
                ids = ids + [EOS_ID]
            if len(ids) > limit:
                ids = ids[: limit - 1] + [EOS_ID]
            out.append(ids)
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(
    model_dir: Optional[str],
    max_length: int = 512,
    vocab_size: int = XLMR_VOCAB,
):
    """Prefer a local tokenizer.json; otherwise the hash fallback."""
    if model_dir:
        tok_file = Path(model_dir) / "tokenizer.json"
        if tok_file.exists():
            try:
                return HFTokenizer(tok_file, max_length=max_length)
            except Exception:
                pass
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)


# Length buckets bound the set of forward shapes while wasting little
# padding; batch size scales inversely so the token count per forward
# stays roughly constant.
LENGTH_BUCKETS: Tuple[int, ...] = (32, 64, 128, 256, 512)


def bucket_length(n: int) -> int:
    for b in LENGTH_BUCKETS:
        if n <= b:
            return b
    return LENGTH_BUCKETS[-1]


def pad_to_bucket(
    ids_batch: Sequence[List[int]], bucket: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of id lists to [B, bucket]; returns (ids, attention_mask)."""
    n = len(ids_batch)
    ids = np.full((n, bucket), PAD_ID, dtype=np.int32)
    mask = np.zeros((n, bucket), dtype=np.int32)
    for i, row in enumerate(ids_batch):
        row = row[:bucket]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask
