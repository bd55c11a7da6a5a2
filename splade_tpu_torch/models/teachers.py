"""BGE-M3 dense teacher: batched encoding on the device, scoring, soft
labels, and the KD loss against it.

Counterpart of ``splade_tpu/models/teachers.py``: a frozen XLM-R encoder
(1024-d normalized CLS embeddings, ``models/xlmr.py``) exposing pairwise
and matrix cosine scoring, per-triplet and in-batch soft labels, and
``kd_loss_with_teacher`` (temperature-scaled KL + MSE). ``from_hf_dir``
reads an HF dir in bf16, as the reference does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from splade_tpu_torch.models.hf_port import read_hf_state
from splade_tpu_torch.models.xlmr import (XlmRobertaConfig, XlmRobertaEncoder,
                                         port_xlmr_state_dict)
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device


def teacher_tokenizer(model_dir: str):
    """The teacher's own tokenizer from its HF dir (``transformers`` is
    imported here only, when no tokenizer is passed)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_dir)


class BGEM3Teacher:
    """Frozen dense teacher over an XLM-R encoder, on ``device`` (``cuda``
    unless the caller asks for the CPU), under ``torch.no_grad``."""

    def __init__(self, model: XlmRobertaEncoder, tokenizer,
                 max_length: int = 512, batch_size: int = 32,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.batch_size = batch_size

    @classmethod
    def from_hf_dir(cls, model_dir: str, tokenizer=None,
                    device: DeviceLike = None, **kwargs) -> "BGEM3Teacher":
        """config.json + weights -> a bf16 teacher."""
        device = resolve_device(device)  # before reading any weight
        cfg = XlmRobertaConfig.from_hf_dict(
            json.loads((Path(model_dir) / "config.json").read_text()),
            dtype=torch.bfloat16)
        state = port_xlmr_state_dict(read_hf_state(model_dir), cfg)
        with torch.device(device):
            model = XlmRobertaEncoder(cfg)
        model.load_state_dict(state)
        if tokenizer is None:
            tokenizer = teacher_tokenizer(model_dir)
        return cls(model, tokenizer, device=device, **kwargs)

    # ------------------------------------------------------------ encode
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """[N, H] L2-normalized dense embeddings, f32."""
        out = []
        for i in range(0, len(texts), self.batch_size):
            enc = self.tokenizer(
                list(texts[i:i + self.batch_size]), padding="max_length",
                truncation=True, max_length=self.max_length,
                return_tensors="np")
            ids, mask = (torch.from_numpy(enc[k].astype(np.int64)).to(
                self.device) for k in ("input_ids", "attention_mask"))
            with torch.no_grad():
                out.append(self.model.encode_cls(ids, mask).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 1), np.float32)

    # ------------------------------------------------------------ scoring
    def score_pairs(self, queries: Sequence[str],
                    docs: Sequence[str]) -> np.ndarray:
        """[N] cosine of aligned (query, doc) pairs."""
        return np.sum(self.encode(queries) * self.encode(docs), axis=-1)

    def score_matrix(self, queries: Sequence[str],
                     docs: Sequence[str]) -> np.ndarray:
        """[Nq, Nd] cosine matrix."""
        return self.encode(queries) @ self.encode(docs).T

    def soft_labels(self, queries: Sequence[str], positives: Sequence[str],
                    negatives: Sequence[str], temperature: float = 1.0
                    ) -> np.ndarray:
        """[N, 2] per-triplet softmax over (pos, neg) teacher scores."""
        s_pos = self.score_pairs(queries, positives)
        s_neg = self.score_pairs(queries, negatives)
        logits = np.stack([s_pos, s_neg], axis=1) / temperature
        logits -= logits.max(axis=1, keepdims=True)
        e = np.exp(logits)
        return e / e.sum(axis=1, keepdims=True)

    def in_batch_soft_labels(self, queries: Sequence[str], docs: Sequence[str],
                             temperature: float = 1.0) -> np.ndarray:
        """[N, N] row-softmax of the in-batch score matrix."""
        m = self.score_matrix(queries, docs) / temperature
        m -= m.max(axis=1, keepdims=True)
        e = np.exp(m)
        return e / e.sum(axis=1, keepdims=True)


def kd_loss_with_teacher(student_scores, teacher_scores,
                         temperature: float = 2.0,
                         mse_weight: float = 0.5) -> torch.Tensor:
    """KL(teacher||student) at temperature T scaled by T^2, plus an MSE
    term on raw scores. Arrays or tensors in, a 0-d f32 tensor out."""
    s = torch.as_tensor(student_scores, dtype=torch.float32)
    t = torch.as_tensor(teacher_scores, dtype=torch.float32, device=s.device)
    t_logp = torch.log_softmax(t / temperature, dim=-1)
    s_logp = torch.log_softmax(s / temperature, dim=-1)
    kl = torch.mean(torch.sum(torch.exp(t_logp) * (t_logp - s_logp), dim=-1))
    mse = torch.mean((s - t) ** 2)
    return temperature ** 2 * kl + mse_weight * mse
