"""Benchmark- and serving-side encoders: texts -> sparse or dense vectors.

Counterpart of ``splade_tpu/benchmark/encoders.py``. ``SparseEncoderV33``:
batched encoding on the device, the banned-token mask (special tokens and
"["/"<"-prefixed markers), documents as nonzero (indices, values) arrays
with an optional per-doc top-k, queries truncated to their strongest
``query_top_k`` tokens by a top-k on the device, so only [B, k] pairs reach
the host. ``from_checkpoint`` loads a training checkpoint (the port's
``model.pt`` or the JAX package's ``model.msgpack``), ``from_hf_dir`` an
exported HF dir, ``from_any`` whichever the path holds. The dense
baselines: ``TeacherDenseEncoder`` (the BGE-M3 teacher of
``models/teachers.py``) and ``PrecomputedDenseEncoder`` (an external
model's embeddings, precomputed to disk).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

SparseVec = Tuple[np.ndarray, np.ndarray]  # (indices int32, values float32)


class SparseEncoderV33:
    """SPLADE encoder for indexing and search, from a ``SpladeEncoder``.

    The model is moved to ``device`` (``cuda`` unless the caller asks for
    the CPU) and runs under ``torch.no_grad``."""

    def __init__(
        self,
        model,
        tokenizer,
        query_max_length: int = 64,
        doc_max_length: int = 256,
        batch_size: int = 32,
        doc_top_k: int = 0,
        query_top_k: int = 64,
        filter_special: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.query_max_length = query_max_length
        self.doc_max_length = doc_max_length
        self.batch_size = batch_size
        self.doc_top_k = doc_top_k
        self.query_top_k = query_top_k
        self._banned = (self._banned_token_mask(tokenizer) if filter_special
                        else None)
        self.banned = (torch.from_numpy(self._banned).to(self.device)
                       if self._banned is not None else None)

    @staticmethod
    def _banned_token_mask(tokenizer) -> np.ndarray:
        """Vocab mask of tokens excluded from sparse vectors: special
        tokens and "["/"<"-prefixed markers."""
        vocab_size = len(tokenizer)
        banned = np.zeros(vocab_size, bool)
        for tid in tokenizer.all_special_ids:
            if 0 <= tid < vocab_size:
                banned[tid] = True
        for tok, tid in tokenizer.get_vocab().items():
            if tid < vocab_size and tok[:1] in ("[", "<"):
                banned[tid] = True
        return banned

    def tokenize(self, texts: Sequence[str], max_length: int):
        """Texts -> (input_ids, attention_mask) int64 tensors on the device."""
        enc = self.tokenizer(
            list(texts), padding="max_length", truncation=True,
            max_length=max_length, return_tensors="np")
        return (torch.from_numpy(enc["input_ids"].astype(np.int64)).to(
                    self.device),
                torch.from_numpy(enc["attention_mask"].astype(np.int64)).to(
                    self.device))

    def encode_tensor(self, ids: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        """[B, S] ids -> [B, V] f32 sparse vectors, banned tokens zeroed."""
        with torch.no_grad():
            repr_ = self.model(ids, mask)[0].to(torch.float32)
            if self.banned is not None:
                repr_ = repr_.masked_fill(self.banned[None, :], 0.0)
        return repr_

    def _to_sparse(self, mat: np.ndarray, top_k: int) -> List[SparseVec]:
        out: List[SparseVec] = []
        for row in mat:
            nz = np.flatnonzero(row > 0)
            vals = row[nz]
            if top_k and len(nz) > top_k:
                keep = np.argpartition(-vals, top_k - 1)[:top_k]
                nz, vals = nz[keep], vals[keep]
            out.append((nz.astype(np.int32), vals.astype(np.float32)))
        return out

    def _encode_texts(self, texts: Sequence[str], max_length: int,
                      top_k: int) -> List[SparseVec]:
        vecs: List[SparseVec] = []
        for i in range(0, len(texts), self.batch_size):
            chunk = list(texts[i:i + self.batch_size])
            mat = self.encode_tensor(*self.tokenize(chunk, max_length))
            vecs.extend(self._to_sparse(mat.cpu().numpy(), top_k))
        return vecs

    def encode_documents(self, texts: Sequence[str]) -> List[SparseVec]:
        return self._encode_texts(texts, self.doc_max_length, self.doc_top_k)

    def encode_queries(self, texts: Sequence[str]) -> List[SparseVec]:
        """Query vectors truncated to the strongest ``query_top_k`` tokens;
        the top-k runs on the device and only [B, k] pairs transfer."""
        if not self.query_top_k:  # 0 = keep the full query vector
            return self._encode_texts(texts, self.query_max_length, 0)
        out: List[SparseVec] = []
        for i in range(0, len(texts), self.batch_size):
            chunk = list(texts[i:i + self.batch_size])
            repr_ = self.encode_tensor(
                *self.tokenize(chunk, self.query_max_length))
            vals, idxs = torch.topk(repr_, self.query_top_k, dim=1)
            vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
            for r in range(len(chunk)):
                nz = vals[r] > 0
                out.append((idxs[r][nz].astype(np.int32),
                            vals[r][nz].astype(np.float32)))
        return out

    def encode_for_query(self, text: str) -> SparseVec:
        """One query's vector, as encode_queries gives it."""
        return self.encode_queries([text])[0]

    @classmethod
    def from_any(cls, path: str, tokenizer=None,
                 **kwargs) -> "SparseEncoderV33":
        """Load from either artifact format: a training checkpoint dir
        (the port's model.pt or the JAX package's model.msgpack) or an
        exported HF dir (config.json + weights)."""
        from splade_tpu_torch.train.checkpoint import MODEL_FILE, MSGPACK_FILE

        if any((Path(path) / f).exists() for f in (MODEL_FILE, MSGPACK_FILE)):
            enc = cls.from_checkpoint(path, tokenizer, **kwargs)
        else:
            enc = cls.from_hf_dir(path, tokenizer, **kwargs)
        enc.source_path = str(path)
        return enc

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, tokenizer,
                        device: DeviceLike = None, config=None,
                        **kwargs) -> "SparseEncoderV33":
        """Load a training checkpoint or final-model dir into a bf16
        ``SpladeEncoder``. The model's shape comes from the tokenizer, as in
        the JAX package (vocab_size = len(tokenizer), its pad id), with the
        architecture's default widths; ``config`` replaces it for a
        checkpoint of other widths (the tests' tiny models)."""
        from splade_tpu_torch.models.modernbert import ModernBertConfig
        from splade_tpu_torch.models.splade import SpladeEncoder
        from splade_tpu_torch.train.checkpoint import load_model_state

        cfg = config or ModernBertConfig(vocab_size=len(tokenizer),
                                         pad_token_id=tokenizer.pad_token_id)
        state = load_model_state(ckpt_dir)
        model = SpladeEncoder(cfg, device=device)
        model.mlm.load_state_dict(state)
        return cls(model.to(torch.bfloat16), tokenizer, device=device,
                   **kwargs)

    @classmethod
    def from_hf_dir(cls, model_dir: str, tokenizer=None,
                    device: DeviceLike = None,
                    **kwargs) -> "SparseEncoderV33":
        """Load an HF-format dir into a bf16 ``SpladeEncoder``."""
        from splade_tpu_torch.models.hf_port import load_hf_checkpoint
        from splade_tpu_torch.models.splade import SpladeEncoder

        if tokenizer is None:
            from splade_tpu_torch.utils.tokenizer import create_tokenizer

            tokenizer = create_tokenizer(model_dir)
        cfg, state = load_hf_checkpoint(model_dir)
        model = SpladeEncoder(cfg, device=device)
        model.mlm.load_state_dict(state)
        return cls(model.to(torch.bfloat16), tokenizer, device=device,
                   **kwargs)


class DenseEncoderBase:
    """Interface for dense baseline encoders: [N, dim] normalized
    embeddings."""

    dim: int = 0

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError


class TeacherDenseEncoder(DenseEncoderBase):
    """Runnable dense (BGE-M3) baseline for the benchmark harness, backed
    by the XLM-R teacher, so the ``semantic`` baseline and every
    sparse+dense hybrid run from the CLI through ``--dense-checkpoint``."""

    def __init__(self, teacher):
        self.teacher = teacher
        self.dim = int(teacher.model.config.hidden_size)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        return self.teacher.encode(texts)

    @classmethod
    def from_hf_dir(cls, model_dir: str, max_length: int = 512,
                    batch_size: int = 16, tokenizer=None,
                    device: DeviceLike = None) -> "TeacherDenseEncoder":
        from splade_tpu_torch.models.teachers import BGEM3Teacher

        return cls(BGEM3Teacher.from_hf_dir(
            model_dir, tokenizer=tokenizer, device=device,
            max_length=max_length, batch_size=batch_size))


class PrecomputedDenseEncoder(DenseEncoderBase):
    """Embeddings from an external model, precomputed to disk: compute
    them with any service offline, save them with :meth:`save_embeddings`,
    and plug the file into the benchmark runner through
    ``--external-dense``. Lookup is md5(text) -> L2-normalized vector."""

    def __init__(self, path: str):
        import hashlib

        z = np.load(path, allow_pickle=False)
        self._hash = hashlib.md5
        hashes = [h.decode() if isinstance(h, bytes) else str(h)
                  for h in z["hashes"]]
        emb = np.asarray(z["embeddings"], np.float32)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
        self._table = dict(zip(hashes, emb))
        self.dim = int(emb.shape[1])

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        missing = 0
        for i, t in enumerate(texts):
            v = self._table.get(self._hash(t.encode("utf-8")).hexdigest())
            if v is None:
                missing += 1
            else:
                out[i] = v
        if missing:
            raise KeyError(
                f"{missing}/{len(texts)} texts missing from the precomputed "
                "embedding table — re-run the offline embedding job over the "
                "full corpus+queries")
        return out

    @staticmethod
    def save_embeddings(path: str, texts: Sequence[str],
                        embeddings: np.ndarray) -> None:
        import hashlib

        hashes = np.asarray(
            [hashlib.md5(t.encode("utf-8")).hexdigest() for t in texts])
        np.savez_compressed(path, hashes=hashes,
                            embeddings=np.asarray(embeddings, np.float32))
