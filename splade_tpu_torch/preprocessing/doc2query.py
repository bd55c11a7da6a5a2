"""doc2query document expansion
(a copy of ``splade_tpu/preprocessing/doc2query.py``).

Reference: scripts/expand_documents.py (append N generated queries to each
positive as ``"{doc} [SEP] {q1} ... {qN}"``, thread-pooled over shards,
atomic writes) and scripts/finetune_doc2query.py (fine-tune pko-t5-base on
KorQuAD context->question with Seq2SeqTrainer).

The generator is pluggable: any callable ``texts -> list[list[str]]``. A
torch/HF T5 wrapper is provided for hosts with a local checkpoint; the
fine-tune entry point wraps HF Seq2SeqTrainer and is gated on torch being
functional (zero-egress hosts must supply local checkpoints/data).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Sequence

logger = logging.getLogger(__name__)

Generator = Callable[[Sequence[str]], List[List[str]]]


def expand_shard(
    shard_path: str,
    generator: Generator,
    num_queries: int = 5,
    batch_size: int = 16,
    sep: str = " [SEP] ",
) -> int:
    """Expand every positive in one shard; atomic rewrite. Returns count."""
    rows = []
    with open(shard_path, encoding="utf-8") as f:
        rows = [json.loads(l) for l in f if l.strip()]
    docs = [r["positive"] for r in rows]
    expanded = 0
    for start in range(0, len(docs), batch_size):
        chunk = docs[start:start + batch_size]
        gen = generator(chunk)
        for i, queries in enumerate(gen):
            queries = [q.strip() for q in queries[:num_queries] if q.strip()]
            if queries:
                rows[start + i]["positive"] = (
                    rows[start + i]["positive"] + sep + " ".join(queries))
                expanded += 1
    fd, tmp = tempfile.mkstemp(dir=str(Path(shard_path).parent))
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    os.replace(tmp, shard_path)
    logger.info("expanded %d/%d docs in %s", expanded, len(rows), shard_path)
    return expanded


def expand_documents(
    shard_paths: Sequence[str],
    generator: Generator,
    num_queries: int = 5,
    max_workers: int = 4,
) -> int:
    """Thread-pooled expansion over shards (reference: expand_documents.py)."""
    total = 0
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for n in pool.map(
                lambda p: expand_shard(p, generator, num_queries), shard_paths):
            total += n
    return total


class T5QueryGenerator:
    """HF seq2seq generator from a LOCAL checkpoint dir (torch inference)."""

    def __init__(self, model_dir: str, max_input: int = 384,
                 max_output: int = 64, num_queries: int = 5):
        import torch
        from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_dir)
        self.model = AutoModelForSeq2SeqLM.from_pretrained(model_dir).eval()
        self.max_input = max_input
        self.max_output = max_output
        self.num_queries = num_queries
        self._torch = torch

    def __call__(self, texts: Sequence[str]) -> List[List[str]]:
        torch = self._torch
        enc = self.tokenizer(list(texts), padding=True, truncation=True,
                             max_length=self.max_input, return_tensors="pt")
        with torch.no_grad():
            out = self.model.generate(
                **enc, max_length=self.max_output, do_sample=True, top_k=10,
                num_return_sequences=self.num_queries)
        decoded = self.tokenizer.batch_decode(out, skip_special_tokens=True)
        k = self.num_queries
        return [decoded[i * k:(i + 1) * k] for i in range(len(texts))]


def finetune_doc2query(
    base_model_dir: str,
    train_pairs: Sequence[tuple],
    output_dir: str,
    epochs: int = 1,
    lr: float = 3e-4,
    batch_size: int = 8,
) -> str:
    """Fine-tune a seq2seq model on (context, question) pairs.

    Reference: scripts/finetune_doc2query.py (pko-t5-base on KorQuAD,
    Seq2SeqTrainer). ``train_pairs``: iterable of (context, question).
    """
    import torch
    from torch.utils.data import DataLoader, Dataset
    from transformers import AutoModelForSeq2SeqLM, AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(base_model_dir)
    model = AutoModelForSeq2SeqLM.from_pretrained(base_model_dir)

    class PairDataset(Dataset):
        def __len__(self):
            return len(train_pairs)

        def __getitem__(self, i):
            ctx, q = train_pairs[i]
            enc = tokenizer(ctx, truncation=True, max_length=384,
                            padding="max_length", return_tensors="pt")
            lab = tokenizer(q, truncation=True, max_length=64,
                            padding="max_length", return_tensors="pt")
            labels = lab["input_ids"][0]
            labels[labels == tokenizer.pad_token_id] = -100
            return {"input_ids": enc["input_ids"][0],
                    "attention_mask": enc["attention_mask"][0],
                    "labels": labels}

    if not train_pairs:
        raise ValueError("finetune_doc2query: no training pairs "
                         "(upstream filtering removed everything?)")
    loader = DataLoader(PairDataset(), batch_size=batch_size, shuffle=True)
    opt = torch.optim.AdamW(model.parameters(), lr=lr)
    model.train()
    for epoch in range(epochs):
        total, n_batches = 0.0, 0
        for batch in loader:
            loss = model(**batch).loss
            loss.backward()
            opt.step()
            opt.zero_grad()
            total += float(loss)
            n_batches += 1
        logger.info("doc2query epoch %d mean loss %.4f (%d batches)",
                    epoch + 1, total / max(n_batches, 1), n_batches)
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    model.save_pretrained(output_dir)
    tokenizer.save_pretrained(output_dir)
    return output_dir
