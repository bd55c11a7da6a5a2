"""Text helpers: the k -> tier quantizer shared by the serving engine and
the postings index, and the Hangul tests of the BM25 analyzers and the
offline data tier (counterparts of ``splade_tpu/utils/text.py``'s
``quantize_to_tier``, ``is_hangul_char``, ``contains_hangul`` and
``hangul_count``)."""

from __future__ import annotations

from typing import Optional, Sequence


def is_hangul_char(ch: str, include_jamo: bool = False) -> bool:
    """True for a precomposed Hangul syllable (U+AC00–U+D7A3); with
    include_jamo also conjoining Jamo (U+1100–U+11FF) — analyzers that
    stem decomposed forms want the wider set, data filters the narrow."""
    if "가" <= ch <= "힣":
        return True
    return include_jamo and "ᄀ" <= ch <= "ᇿ"


def contains_hangul(text: str, include_jamo: bool = False) -> bool:
    return any(is_hangul_char(c, include_jamo) for c in text)


def hangul_count(text: str, include_jamo: bool = False) -> int:
    return sum(1 for c in text if is_hangul_char(c, include_jamo))


def quantize_to_tier(k: int, tiers: Sequence[int],
                     cap: Optional[int] = None,
                     round_to: int = 1000) -> int:
    """Round k up to a fixed tier, so the set of top-k widths stays small.
    Beyond the tier table, round up to a multiple of ``round_to``; clamp to
    ``cap`` when given."""
    out = k
    for tier in tiers:
        if k <= tier:
            out = tier
            break
    else:
        out = -(-k // round_to) * round_to
    return min(out, cap) if cap is not None else out
