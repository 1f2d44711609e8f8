"""Deterministic EN/IT language detection (copy of the JAX package's
``utils/lang.py``, same decisions on every input).

A self-contained detector for a two-way "en"/"it" decision with "en" as
the fallback: a weighted vote over function words, characteristic
suffixes, and accented characters. Pure and deterministic.
"""

from __future__ import annotations

import re

_WORD_RE = re.compile(r"[a-zà-öø-ÿ]+", re.IGNORECASE)

# High-frequency function words. A hit is strong evidence; these sets are
# disjoint on purpose (shared romance/english words like "a", "la" in songs
# are excluded or kept only where unambiguous).
_EN_WORDS = frozenset(
    """the and of to in is that it for on with as are was this be by an or
    from at which you have not has they his her its but had were all can
    will would there their what when how who where your out about into than
    then them these those does did doing been being only other some such"""
    .split()
)
_IT_WORDS = frozenset(
    """il lo la gli le di che è per una uno con non sono del della dei delle
    nel nella dal dalla sul sulla al alla ai alle un ed anche come più ma se
    questo questa questi queste quello quella ci si mi ti vi ne era erano
    essere stato stata avere aveva hanno perché quando dove cosa molto dopo
    prima tra fra ogni tutti tutte tutto tutta può sia già così ancora poi
    quindi infatti cioè ovvero senza verso presso"""
    .split()
)

# Characteristic word endings (checked on words of length >= 4).
_IT_SUFFIXES = ("zione", "zioni", "mente", "ità", "aggio", "ezza", "iamo",
                "ano", "ono", "are", "ere", "ire", "ato", "uto", "ita")
_EN_SUFFIXES = ("tion", "tions", "ing", "ness", "ment", "ally", "ould",
                "ough", "ers", "ies", "ted", "ely")

_IT_ACCENTS = frozenset("àèéìòù")


def detect_lang_tag(text: str) -> str:
    """Return "en" or "it"; defaults to "en" when evidence is thin."""
    if not text:
        return "en"
    sample = text[:4000].lower()
    words = _WORD_RE.findall(sample)
    if not words:
        return "en"

    en_score = 0.0
    it_score = 0.0
    for w in words:
        if w in _EN_WORDS:
            en_score += 3.0
        elif w in _IT_WORDS:
            it_score += 3.0
        if len(w) >= 4:
            if w.endswith(_IT_SUFFIXES):
                it_score += 1.0
            if w.endswith(_EN_SUFFIXES):
                en_score += 1.0
        # Italian words overwhelmingly end in vowels; use as a weak signal.
        if len(w) >= 3 and w[-1] in "aeiou":
            it_score += 0.15
        elif len(w) >= 3:
            en_score += 0.1

    it_score += 2.0 * sum(1 for ch in sample if ch in _IT_ACCENTS)

    # Require a real margin before calling Italian: the reference maps every
    # non-IT language (and low confidence) to English.
    if it_score > en_score * 1.05 and it_score >= 2.0:
        return "it"
    return "en"
