"""Mid-training retrieval evaluation (port of ``splade_tpu/train/eval.py``).

The reference's ``MidTrainingEvaluator`` contract (reference call sites
train_v33_ddp.py:631-644,684): every N epochs, encode <=200 val queries and
<=1000 val docs with the *training* model, rank by exact sparse dot
product, report recall@{1,5,10} and MRR. The caller sets the compute dtype
(the Trainer evaluates under its autocast).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


class MidTrainingEvaluator:
    def __init__(
        self,
        val_samples: List[Dict[str, Any]],
        collator,
        max_queries: int = 200,
        max_docs: int = 1000,
        batch_size: int = 32,
    ):
        self.collator = collator
        self.batch_size = batch_size
        queries, docs, qrels = [], [], {}
        doc_idx: Dict[str, int] = {}
        for s in val_samples:
            if len(queries) < max_queries:
                q = s["query"]
                pos = s["positive"]
                if pos not in doc_idx and len(docs) < max_docs:
                    doc_idx[pos] = len(docs)
                    docs.append(pos)
                if pos in doc_idx:
                    qrels[len(queries)] = doc_idx[pos]
                    queries.append(q)
            negs = s.get("negatives") or ([s["negative"]] if s.get("negative") else [])
            for n in negs:
                if n not in doc_idx and len(docs) < max_docs:
                    doc_idx[n] = len(docs)
                    docs.append(n)
        self.queries, self.docs, self.qrels = queries, docs, qrels

    @torch.no_grad()
    def _encode_texts(self, model, texts: List[str],
                      is_query: bool) -> np.ndarray:
        max_len = (self.collator.query_max_length if is_query
                   else self.collator.doc_max_length)
        dev = next(model.parameters()).device
        reprs = []
        for i in range(0, len(texts), self.batch_size):
            chunk = texts[i:i + self.batch_size]
            pad = self.batch_size - len(chunk)
            enc = self.collator._tokenize(chunk + [""] * pad, max_len)
            out = model(torch.from_numpy(enc["input_ids"]).to(dev),
                        torch.from_numpy(enc["attention_mask"]).to(dev))[0]
            reprs.append(out.float().cpu().numpy()[: len(chunk)])
        return np.concatenate(reprs) if reprs else np.zeros((0, 1), np.float32)

    def evaluate(self, model) -> Dict[str, float]:
        if not self.queries or not self.docs:
            return {}
        q = self._encode_texts(model, self.queries, is_query=True)
        d = self._encode_texts(model, self.docs, is_query=False)
        scores = q @ d.T  # [Q, D] exact sparse dot product
        ranks = []
        for qi in range(len(self.queries)):
            gold = self.qrels[qi]
            ranks.append(int((scores[qi] > scores[qi, gold]).sum()) + 1)
        ranks = np.asarray(ranks)
        return {
            "recall@1": float((ranks <= 1).mean()),
            "recall@5": float((ranks <= 5).mean()),
            "recall@10": float((ranks <= 10).mean()),
            "mrr": float((1.0 / ranks).mean()),
            "num_queries": float(len(ranks)),
            "num_docs": float(len(self.docs)),
        }
