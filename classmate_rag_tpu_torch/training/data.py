"""Training-pair mining for contrastive encoder fine-tuning (port of
the JAX package's ``training/data.py``, with the port's own chunker,
catalog and tokenizer padding).

Builds (query, passage) pairs straight from the indexed corpus — no
labels needed. Two deterministic pseudo-query strategies per chunk:

- "lead": the chunk's first sentence queries the remainder (classic
  inverse-cloze task);
- "terms": the chunk's most distinctive terms (highest tf·idf against
  the catalog) form a keyword query for the full chunk.

Pairs feed ``training.make_train_step`` via ``encode_pairs``, which
tokenizes and pads into fixed-shape batches.
"""

from __future__ import annotations

import math
from hashlib import blake2b
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from classmate_rag_tpu_torch.chunking.chunker import sentence_split
from classmate_rag_tpu_torch.embeddings.tokenizer import pad_to_bucket
from classmate_rag_tpu_torch.index.catalog import Catalog


def _stable_choice(key: str, n: int) -> int:
    return int.from_bytes(blake2b(key.encode(), digest_size=4).digest(),
                          "little") % max(n, 1)


def mine_pairs(
    catalog: Catalog,
    *,
    max_pairs: int = 10_000,
    min_chunk_chars: int = 80,
    terms_per_query: int = 4,
) -> List[Tuple[str, str]]:
    """Deterministic (query, passage) pairs from the catalog."""
    # Corpus df for tf·idf term selection.
    df: Dict[str, int] = {}
    entries = [e for e in catalog.entries() if len(e.text) >= min_chunk_chars]
    for e in entries:
        for t in set(e.tokens):
            df[t] = df.get(t, 0) + 1
    n_docs = max(len(entries), 1)

    pairs: List[Tuple[str, str]] = []
    for e in entries:
        if len(pairs) >= max_pairs:
            break
        if _stable_choice(e.id, 2) == 0:
            sents = sentence_split(e.text)
            if len(sents) >= 2:
                pairs.append((sents[0], " ".join(sents[1:])))
                continue
        # "terms" strategy (also the fallback for single-sentence chunks).
        counts: Dict[str, int] = {}
        for t in e.tokens:
            counts[t] = counts.get(t, 0) + 1
        scored = sorted(
            counts.items(),
            key=lambda kv: -(kv[1] * math.log(1 + n_docs / (df.get(kv[0], 1)))),
        )
        terms = [t for t, _ in scored[:terms_per_query]]
        if terms:
            pairs.append((" ".join(terms), e.text))
    return pairs


def encode_pairs(
    pairs: Sequence[Tuple[str, str]],
    tokenizer,
    *,
    batch_size: int = 32,
    seq_len: int = 128,
) -> Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (q_ids, q_mask, p_ids, p_mask) int32 batches of fixed shape.

    Queries get the E5 "query: " prefix and passages "passage: " so
    fine-tuning matches inference-time encoding. The trailing partial
    batch is dropped (in-batch negatives need full rows).
    """
    for start in range(0, len(pairs) - batch_size + 1, batch_size):
        group = pairs[start : start + batch_size]
        q_rows = [tokenizer.encode(f"query: {q}", max_length=seq_len)
                  for q, _ in group]
        p_rows = [tokenizer.encode(f"passage: {p}", max_length=seq_len)
                  for _, p in group]
        q_ids, q_mask = pad_to_bucket(q_rows, seq_len)
        p_ids, p_mask = pad_to_bucket(p_rows, seq_len)
        yield q_ids, q_mask, p_ids, p_mask
