"""Korean text cleaning (a copy of ``splade_tpu/preprocessing/cleaners.py``).

Reference: src/preprocessing/cleaners/text_cleaner.py:11-218
(KoreanTextCleaner): NFC normalization, URL/email/HTML stripping,
Hangul-ratio and special-character-ratio filters, whitespace collapsing,
length bounds.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Optional

_URL = re.compile(r"https?://\S+|www\.\S+")
_EMAIL = re.compile(r"\S+@\S+\.\S+")
_HTML = re.compile(r"<[^>]{1,200}>")
_WS = re.compile(r"\s+")
_HANGUL = re.compile(r"[가-힣]")
_WORDISH = re.compile(r"[가-힣A-Za-z0-9\s]")


@dataclass
class CleanStats:
    seen: int = 0
    kept: int = 0
    dropped_length: int = 0
    dropped_hangul: int = 0
    dropped_special: int = 0


class KoreanTextCleaner:
    def __init__(
        self,
        min_hangul_ratio: float = 0.1,
        max_special_char_ratio: float = 0.3,
        min_length: int = 5,
        max_length: int = 10_000,
    ):
        self.min_hangul_ratio = min_hangul_ratio
        self.max_special_char_ratio = max_special_char_ratio
        self.min_length = min_length
        self.max_length = max_length
        self.stats = CleanStats()

    def normalize(self, text: str) -> str:
        """NFC + strip URLs/emails/HTML + collapse whitespace."""
        text = unicodedata.normalize("NFC", text)
        text = _URL.sub(" ", text)
        text = _EMAIL.sub(" ", text)
        text = _HTML.sub(" ", text)
        return _WS.sub(" ", text).strip()

    def hangul_ratio(self, text: str) -> float:
        letters = [c for c in text if not c.isspace()]
        if not letters:
            return 0.0
        return len(_HANGUL.findall(text)) / len(letters)

    def special_char_ratio(self, text: str) -> float:
        if not text:
            return 1.0
        return 1.0 - len(_WORDISH.findall(text)) / len(text)

    def clean(self, text: str) -> Optional[str]:
        """Normalize and filter; None = rejected."""
        self.stats.seen += 1
        text = self.normalize(text)
        if not (self.min_length <= len(text) <= self.max_length):
            self.stats.dropped_length += 1
            return None
        if self.hangul_ratio(text) < self.min_hangul_ratio:
            self.stats.dropped_hangul += 1
            return None
        if self.special_char_ratio(text) > self.max_special_char_ratio:
            self.stats.dropped_special += 1
            return None
        self.stats.kept += 1
        return text
