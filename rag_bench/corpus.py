"""The one general generator: a corpus and a traffic mix from a
configuration file, a traffic file and ``--seed``.

The same seed gives the same inputs. The bulk (word draws and vectors) is
drawn on the run's device with a seeded ``torch.Generator`` in a few large
calls; lengths, metadata and queries come from numpy generators seeded
from the same ``--seed``. Vectors are made in float16, the type the store
serves them in; query vectors are float32, as an encoder hands them over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# Streams drawn from one --seed.
_LENGTHS, _BULK, _QUERIES, _SAMPLE = range(4)


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit seed for one stream of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence(int(seed) % (1 << 64), spawn_key=(stream,))
    return int(ss.generate_state(1, np.uint64)[0])


def stream_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def zipf_cdf(vocab: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


@dataclass
class Corpus:
    words: np.ndarray        # object [V]: the word strings "w0", "w1", ...
    tokens: np.ndarray       # int32 [T]: word ids, passage after passage
    offsets: np.ndarray      # int64 [n + 1]
    emb: np.ndarray          # float16 [n, d], unit rows
    course: np.ndarray       # int32 [n]
    _course_rows: Dict[int, np.ndarray] = field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    def token_lists(self, start: int, end: int) -> List[np.ndarray]:
        """Passages ``start..end`` as sequences of word strings (views of
        one object array: the store iterates them)."""
        a, b = self.offsets[start], self.offsets[end]
        flat = self.words[self.tokens[a:b]]
        return np.split(flat, self.offsets[start + 1:end] - a)

    def metadata(self, start: int, end: int) -> List[Dict[str, Any]]:
        return [{"course": f"c{c}", "language": "en", "doc_type": "txt"}
                for c in self.course[start:end].tolist()]

    def course_rows(self, c: int) -> np.ndarray:
        if c not in self._course_rows:
            self._course_rows[c] = np.flatnonzero(self.course == c)
        return self._course_rows[c]


def make_corpus(cfg: Dict[str, Any], seed: int, device) -> Corpus:
    n, d, vocab = int(cfg["passages"]), int(cfg["dim"]), int(cfg["vocab"])
    rng = stream_rng(seed, _LENGTHS)
    lo, hi = cfg["passage_words"]
    lengths = rng.integers(lo, hi + 1, size=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    course = rng.integers(0, int(cfg["courses"]), size=n).astype(np.int32)

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, _BULK))
    cdf = torch.from_numpy(zipf_cdf(vocab, float(cfg["zipf_s"]))).to(dev)
    u = torch.rand(int(offsets[-1]), dtype=torch.float64, generator=g,
                   device=dev)
    tokens = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    tokens = tokens.to(torch.int32).cpu().numpy()
    del u
    emb = torch.randn((n, d), generator=g, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    emb16 = emb.to(torch.float16).cpu().numpy()
    del emb
    words = np.array([f"w{i}" for i in range(vocab)], dtype=object)
    return Corpus(words, tokens, offsets, emb16, course)


@dataclass
class Batch:
    q_vecs: np.ndarray              # float32 [B, d]
    term_ids: List[np.ndarray]      # word ids of each query (int32)
    terms: List[List[str]]          # the same as word strings
    where: Optional[Dict[str, str]]
    course: Optional[int]           # the filter's course, None unfiltered


def make_batches(corpus: Corpus, cfg: Dict[str, Any],
                 traffic: Dict[str, Any], seed: int) -> List[Batch]:
    """The mix's pool of distinct batches, which the loop serves in turn.
    Each query comes from a source passage (of the batch's course under a
    course filter): its vector is the passage's plus Gaussian noise,
    renormalised; its words are drawn without replacement from the
    passage's word positions."""
    rng = stream_rng(seed, _QUERIES)
    bsz, n_pool = int(traffic["batch"]), int(traffic["pool_batches"])
    qlo, qhi = cfg["query_words"]
    noise = float(cfg["query_noise"])
    scheme = traffic.get("filter")
    if scheme not in (None, "course"):
        raise ValueError(f"unknown filter scheme {scheme!r}")
    out = []
    for _ in range(n_pool):
        course = where = None
        if scheme == "course":
            course = int(rng.integers(0, int(cfg["courses"])))
            where = {"course": f"c{course}"}
            src = rng.choice(corpus.course_rows(course), size=bsz)
        else:
            src = rng.integers(0, corpus.n, size=bsz)
        q = corpus.emb[src].astype(np.float32)
        q += noise * rng.standard_normal(q.shape, dtype=np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        lens = rng.integers(qlo, qhi + 1, size=bsz)
        ids = []
        for s, ln in zip(src.tolist(), lens.tolist()):
            a, b = corpus.offsets[s], corpus.offsets[s + 1]
            pos = rng.choice(b - a, size=min(ln, b - a), replace=False)
            ids.append(corpus.tokens[a + pos])
        if not traffic.get("hybrid", True):
            ids = [t[:0] for t in ids]
        terms = [corpus.words[t].tolist() for t in ids]
        out.append(Batch(np.ascontiguousarray(q), ids, terms, where, course))
    return out
