"""Task-specific converters: RawSample -> Triplet
(a copy of ``splade_tpu/preprocessing/converters.py``).

Reference: src/preprocessing/converters/ (8 converters over nli / qa / sts /
classification / dialog / AI-Hub sources, base.py:11-102). Conversion rules:

- NLI: premise=query, entailment hypothesis=positive, contradiction=negative.
- QA: question=query, answer passage/context=positive (negatives mined later).
- STS: high-similarity pair (score >= pos threshold) -> query/positive;
  low-similarity pair supplies the negative.
- Classification: same-label texts are positives, different-label negatives.
- Dialog: utterance=query, response=positive.
- Pair: generic (text_a, text_b[, negative]) passthrough.
"""

from __future__ import annotations

import logging
import random
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

from splade_tpu_torch.preprocessing.types import RawSample, Triplet

logger = logging.getLogger(__name__)


class BaseConverter:
    task = "base"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        raise NotImplementedError

    @staticmethod
    def _mk(query, positive, negative=None, pair_type="", source="") -> Optional[Triplet]:
        t = Triplet(query=query or "", positive=positive or "",
                    negative=negative, pair_type=pair_type, source=source)
        return t if t.is_valid() else None


class NLIConverter(BaseConverter):
    task = "nli"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        # Group hypotheses by premise and label.
        by_premise: Dict[str, Dict[str, List[str]]] = defaultdict(lambda: defaultdict(list))
        src = samples[0].source if samples else ""
        for s in samples:
            f = s.fields
            label = str(f.get("label", "")).lower()
            by_premise[f.get("premise", "")][label].append(f.get("hypothesis", ""))
        out: List[Triplet] = []
        for premise, groups in by_premise.items():
            ents = groups.get("entailment", []) or groups.get("0", [])
            cons = groups.get("contradiction", []) or groups.get("2", [])
            for i, pos in enumerate(ents):
                neg = cons[i % len(cons)] if cons else None
                t = self._mk(premise, pos, neg, "nli", src)
                if t:
                    out.append(t)
        return out


class QAConverter(BaseConverter):
    task = "qa"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        out = []
        for s in samples:
            f = s.fields
            t = self._mk(f.get("question"), f.get("context") or f.get("answer"),
                         None, "qa", s.source)
            if t:
                out.append(t)
        return out


class STSConverter(BaseConverter):
    task = "sts"

    #: autodetect only trusts a batch this large — a smaller all-low-score
    #: shard of a genuine 0-5 dataset must not be mistaken for normalized
    MIN_AUTODETECT_SAMPLES = 20

    def __init__(self, pos_threshold: float = 4.0, neg_threshold: float = 1.5,
                 scale: float = 5.0, normalized: bool | None = None):
        """Thresholds are on KorSTS's native 0-5 scale. ``normalized``
        states explicitly whether scores arrive 0-1 (rescaled by ``scale``)
        — pass it from the dataset spec when known. ``None`` autodetects,
        but conservatively: it needs >= MIN_AUTODETECT_SAMPLES rows, max
        <= 1, AND at least one fractional score strictly inside (0, 1) —
        a small or integer-scored batch of a genuine 0-5 dataset (e.g. an
        all-dissimilar shard) is NOT rescaled."""
        self.pos_threshold = pos_threshold
        self.neg_threshold = neg_threshold
        self.scale = scale
        self.normalized = normalized

    def _is_normalized(self, raw: List[float]) -> bool:
        if self.normalized is not None:
            return self.normalized
        return (len(raw) >= self.MIN_AUTODETECT_SAMPLES
                and max(raw) <= 1.0
                and any(0.0 < x < 1.0 for x in raw))

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        pos_pairs, neg_texts = [], []
        src = samples[0].source if samples else ""
        raw = [float(s.fields.get("score", 0.0)) for s in samples]
        normalized = bool(raw) and self._is_normalized(raw)
        if (self.normalized is None and raw and not normalized
                and max(raw) <= 1.0):
            # ambiguous: every score fits a 0-1 scale but autodetect
            # declined (small batch, or only {0,1} values — e.g. a
            # binary-similarity dataset, whose 1.0 pairs would silently
            # become NEGATIVES on the assumed 0-5 scale). Never guess
            # silently: tell the caller to state the scale.
            logger.warning(
                "STSConverter(%s): all %d scores <= 1.0 but autodetect "
                "declined to rescale (%s); treating as 0-%g scale — pass "
                "normalized=True/False explicitly if this is wrong",
                src, len(raw),
                "no fractional score in (0,1)"
                if len(raw) >= self.MIN_AUTODETECT_SAMPLES
                else f"fewer than {self.MIN_AUTODETECT_SAMPLES} samples",
                self.scale)
        for s, score in zip(samples, raw):
            f = s.fields
            if normalized:
                score *= self.scale
            if score >= self.pos_threshold:
                pos_pairs.append((f.get("sentence1", ""), f.get("sentence2", "")))
            elif score <= self.neg_threshold:
                neg_texts.append(f.get("sentence2", ""))
        out = []
        for i, (a, b) in enumerate(pos_pairs):
            neg = neg_texts[i % len(neg_texts)] if neg_texts else None
            t = self._mk(a, b, neg, "sts", src)
            if t:
                out.append(t)
        return out


class ClassificationConverter(BaseConverter):
    task = "classification"

    def __init__(self, max_per_label: int = 1000, seed: int = 42):
        self.max_per_label = max_per_label
        self.seed = seed

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        rng = random.Random(self.seed)
        by_label: Dict[str, List[str]] = defaultdict(list)
        src = samples[0].source if samples else ""
        for s in samples:
            f = s.fields
            by_label[str(f.get("label"))].append(f.get("text", ""))
        labels = sorted(by_label)
        out: List[Triplet] = []
        for label in labels:
            texts = by_label[label][: self.max_per_label]
            others = [l for l in labels if l != label and by_label[l]]
            for i in range(len(texts) - 1):
                neg = (rng.choice(by_label[rng.choice(others)]) if others else None)
                t = self._mk(texts[i], texts[i + 1], neg, "classification", src)
                if t:
                    out.append(t)
        return out


class DialogConverter(BaseConverter):
    task = "dialog"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        out = []
        for s in samples:
            f = s.fields
            t = self._mk(f.get("utterance") or f.get("instruction"),
                         f.get("response") or f.get("output"),
                         None, "dialog", s.source)
            if t:
                out.append(t)
        return out


class PairConverter(BaseConverter):
    task = "pair"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        out = []
        for s in samples:
            f = s.fields
            t = self._mk(f.get("query") or f.get("text_a"),
                         f.get("positive") or f.get("text_b"),
                         f.get("negative"), f.get("pair_type", "pair"), s.source)
            if t:
                out.append(t)
        return out


class TripletDirectConverter(BaseConverter):
    """Pass-through for sources that already ship retrieval triplets
    (reference: ko-triplet-v1.0 — query/document/hard_negative,
    collect_korean_datasets.py:425-455)."""

    task = "triplet"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        out = []
        for s in samples:
            f = s.fields
            t = self._mk(f.get("query"),
                         f.get("document") or f.get("positive"),
                         f.get("hard_negative") or f.get("negative"),
                         "retrieval_triplet", s.source)
            if t:
                t.difficulty = "hard"
                out.append(t)
        return out


class WebPassageConverter(BaseConverter):
    """Raw web/encyclopedia text -> passage pairs: first short Korean-heavy
    paragraph as the query side, the next as the positive (reference:
    mC4-ko / Korean Wikipedia, collect_korean_datasets.py:270-395)."""

    task = "web_passage"

    min_hangul = 50
    max_query_chars = 200

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        import re

        from splade_tpu_torch.utils.text import hangul_count

        out = []
        for s in samples:
            text = s.fields.get("text", "") or ""
            paras = [p.strip() for p in re.split(r"\n\s*\n|\n", text)
                     if p.strip()]
            korean = [p for p in paras
                      if hangul_count(p) >= self.min_hangul]
            # first SHORT Korean-heavy paragraph as the query side, the
            # next paragraph as the positive — web/encyclopedia articles
            # usually open with a long lead, so scan instead of requiring
            # korean[0] itself to be short
            qi = next((i for i, p in enumerate(korean[:-1])
                       if len(p) < self.max_query_chars), None)
            if qi is None:
                continue
            t = self._mk(korean[qi], korean[qi + 1], None, "web_passage",
                         s.source)
            if t:
                out.append(t)
        return out


class TranslationConverter(BaseConverter):
    """Parallel KO-EN sentences -> bilingual pairs (reference: opus-100
    en-ko, collect_korean_datasets.py:400-424): Korean side queries the
    English side so the model learns the cross-lingual bridge."""

    task = "translation"

    def convert(self, samples: List[RawSample]) -> List[Triplet]:
        out = []
        for s in samples:
            f = s.fields
            tr = f.get("translation") or f
            ko, en = tr.get("ko", ""), tr.get("en", "")
            if not ko or not en:
                continue
            t = self._mk(ko, f"{ko} ({en})", None, "translation", s.source)
            if t:
                out.append(t)
        return out


CONVERTERS = {
    "nli": NLIConverter,
    "qa": QAConverter,
    "sts": STSConverter,
    "classification": ClassificationConverter,
    "dialog": DialogConverter,
    "pair": PairConverter,
    "triplet": TripletDirectConverter,
    "web_passage": WebPassageConverter,
    "translation": TranslationConverter,
}


def get_converter(task: str) -> BaseConverter:
    if task not in CONVERTERS:
        raise KeyError(f"no converter for task '{task}'")
    return CONVERTERS[task]()
