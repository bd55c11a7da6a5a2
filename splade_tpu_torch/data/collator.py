"""Fixed-shape triplet collation (a copy of ``splade_tpu/data/collator.py``).

Reference behavior: src/train/data/dataloader.py:13-164 (TripletCollator) —
asymmetric query/doc truncation, multi-negative flattening to [B*k, S] with
short lists padded by the last negative or the positive, teacher-score
passthrough ([B] or [B, k]), raw-text/metadata passthrough.

Every batch is padded to ``query_max_length`` / ``doc_max_length`` (or to a
length bucket), as in the JAX package, so the port sees the same shapes and
the packed query tower always applies; the reference pads dynamically to
the longest sequence in the batch.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class TripletCollator:
    def __init__(
        self,
        tokenizer,
        max_length: int = 256,
        query_max_length: Optional[int] = None,
        doc_max_length: Optional[int] = None,
        num_hard_negatives: int = 1,
        length_buckets: Optional[Sequence[int]] = None,
    ):
        """length_buckets: optional ascending fractions-of-max sequence
        buckets (e.g. (0.25, 0.5, 1.0)). Each batch is padded to the
        smallest bucket that fits its longest text instead of always to
        max_length — the static-shape counterpart of the reference's
        dynamic padding (XLA compiles one step per bucket; short batches
        run up to buckets[0]/1.0 x faster)."""
        self.tokenizer = tokenizer
        # HF fast tokenizers are NOT thread-safe ("Already borrowed"
        # RuntimeError from the pyo3 RefCell when two threads tokenize
        # concurrently). The collator is shared between the dataloader's
        # prefetch producer thread and the main thread (mid-training
        # eval tokenizes through it while the producer may still be
        # filling its queue after an early epoch exit — observed at
        # max_steps finalization), so every tokenizer call is
        # serialized. Contention is nil: the two only overlap in that
        # drain window, and correctness beats parallelism there.
        self._tok_lock = threading.Lock()
        self.query_max_length = query_max_length or max_length
        self.doc_max_length = doc_max_length or max_length
        self.num_hard_negatives = max(int(num_hard_negatives), 1)
        self.length_buckets = tuple(length_buckets) if length_buckets else None
        if self.length_buckets and any(
                not 0 < f <= 1.0 for f in self.length_buckets):
            raise ValueError(
                f"length_buckets are FRACTIONS of max_length in (0, 1]: "
                f"{self.length_buckets}")

    def _bucket_lengths(self, max_length: int) -> List[int]:
        if not self.length_buckets:
            return [max_length]
        out = sorted({max(8, int(round(max_length * f))) for f in self.length_buckets})
        if out[-1] != max_length:
            out.append(max_length)
        return out

    def _tokenize(self, texts: List[str], max_length: int) -> Dict[str, np.ndarray]:
        buckets = self._bucket_lengths(max_length)
        if len(buckets) == 1:
            with self._tok_lock:
                enc = self.tokenizer(
                    texts, padding="max_length", truncation=True,
                    max_length=max_length, return_tensors="np")
        else:
            # Tokenize unpadded once, pick the smallest fitting bucket.
            with self._tok_lock:
                enc = self.tokenizer(texts, padding=True, truncation=True,
                                     max_length=max_length,
                                     return_tensors="np")
            cur = enc["input_ids"].shape[1]
            target = next(b for b in buckets if b >= cur)
            if target > cur:
                pad_id = self.tokenizer.pad_token_id or 0
                ids = np.full((len(texts), target), pad_id,
                              enc["input_ids"].dtype)
                mask = np.zeros((len(texts), target), enc["attention_mask"].dtype)
                ids[:, :cur] = enc["input_ids"]
                mask[:, :cur] = enc["attention_mask"]
                enc = {"input_ids": ids, "attention_mask": mask}
        return {
            "input_ids": enc["input_ids"].astype(np.int32),
            "attention_mask": enc["attention_mask"].astype(np.int32),
        }

    def _gather_negatives(self, batch: Sequence[Dict[str, Any]]) -> List[str]:
        """Flatten each row to exactly k negative texts.

        Multi-neg rows short of k are padded with their last negative, or the
        positive when empty (reference: dataloader.py:75-92). Single-neg rows
        fall back to the positive when 'negative' is missing.
        """
        k = self.num_hard_negatives
        out: List[str] = []
        for item in batch:
            negs = item.get("negatives")
            if not isinstance(negs, list):
                single = item.get("negative")
                negs = [single] if isinstance(single, str) and single else []
            negs = [n for n in negs if isinstance(n, str) and n]
            while len(negs) < k:
                negs.append(negs[-1] if negs else item["positive"])
            out.extend(negs[:k])
        return out

    def _teacher_scores(
        self, batch: Sequence[Dict[str, Any]]
    ) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """[B] pos scores and [B, k] neg scores, or (None, None) when absent.

        Reference: dataloader.py:134-151 — pass through when every row has
        them; rows short of k neg scores repeat the last one.
        """
        k = self.num_hard_negatives

        def complete(it) -> bool:
            # require the NEGATIVE side too: a row with only a pos score
            # would get a fabricated 0.0 neg score and train MarginMSE
            # toward a made-up (pos - 0.0) margin
            return ("teacher_pos_score" in it
                    and (it.get("teacher_neg_scores")
                         or it.get("teacher_neg_score") is not None))

        if not all(complete(it) for it in batch):
            return None, None
        pos = np.asarray([float(it["teacher_pos_score"]) for it in batch], np.float32)
        negs = np.zeros((len(batch), k), np.float32)
        for i, it in enumerate(batch):
            # mirror complete()'s gate exactly: an EMPTY teacher_neg_scores
            # list falls through to the scalar teacher_neg_score, never to
            # a fabricated 0.0 padding score
            raw = it.get("teacher_neg_scores") or it.get("teacher_neg_score")
            raw = [float(x) for x in (raw if isinstance(raw, list) else [raw])]
            while len(raw) < k:
                raw.append(raw[-1] if raw else 0.0)
            negs[i] = raw[:k]
        return pos, negs

    def __call__(self, batch: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        queries = [it["query"] for it in batch]
        positives = [it["positive"] for it in batch]
        negatives = self._gather_negatives(batch)
        out: Dict[str, Any] = {}
        q = self._tokenize(queries, self.query_max_length)
        # Positives and negatives are tokenized TOGETHER so length bucketing
        # gives them one shape (the trainer concatenates them into a single
        # doc-tower forward).
        docs = self._tokenize(positives + negatives, self.doc_max_length)
        B = len(batch)
        p = {k: v[:B] for k, v in docs.items()}
        n = {k: v[B:] for k, v in docs.items()}
        out["query_input_ids"], out["query_attention_mask"] = q["input_ids"], q["attention_mask"]
        out["positive_input_ids"], out["positive_attention_mask"] = p["input_ids"], p["attention_mask"]
        out["negative_input_ids"], out["negative_attention_mask"] = n["input_ids"], n["attention_mask"]
        out["num_negatives"] = self.num_hard_negatives
        t_pos, t_neg = self._teacher_scores(batch)
        if t_pos is not None:
            out["teacher_pos_scores"], out["teacher_neg_scores"] = t_pos, t_neg
        out["pair_types"] = [it.get("pair_type", "") for it in batch]
        out["difficulties"] = [it.get("difficulty", "") for it in batch]
        return out
