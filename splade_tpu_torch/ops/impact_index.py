"""Dense impact index on the device, single device.

Counterpart of ``splade_tpu/ops/impact_index.py::TpuImpactIndex``: the
corpus is a dense [N, V] matrix (bf16, f32 or int8 with per-row scales)
and a query batch is scored by one [B, V] x [V, N] matrix product plus
top-k. That product is a plain large matrix product, which the reference
leaves to XLA, so it is ``torch.matmul`` here (f32 accumulation of the
bf16-rounded operands, as the reference's dot_general). Right to a few
10^5 docs; ``PostingsIndex`` serves larger corpora.
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

#: corpus rows converted to f32 per matmul, bounding the temporary buffer
_SCORE_CHUNK = 2048


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def impact_scores(queries: torch.Tensor, mat: torch.Tensor, scale,
                  is_int8: bool) -> torch.Tensor:
    """[B, V] queries x [N, V] corpus -> [B, N] f32 scores. int8: bf16
    query times int8 rows, times the per-row scale; else the query in the
    matrix dtype. Products accumulate in f32, chunked over corpus rows."""
    q_dtype = torch.bfloat16 if is_int8 else mat.dtype
    q = queries.to(q_dtype).to(torch.float32)
    out = torch.empty((q.shape[0], mat.shape[0]), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, mat.shape[0], _SCORE_CHUNK):
        rows = mat[lo:lo + _SCORE_CHUNK].to(torch.float32)
        torch.matmul(q, rows.T, out=out[:, lo:lo + _SCORE_CHUNK])
    if is_int8:
        out *= scale[None, :]
    return out


class ImpactIndex:
    """Exact sparse-dot-product retrieval from device memory (counterpart
    of ``TpuImpactIndex``; the mesh-sharded layout waits)."""

    def __init__(
        self,
        vocab_size: int,
        dtype: str = "bfloat16",
        quantize_int8: bool = False,
        batch_pad: int = 8,
        max_docs: int = 100_000,
        device: DeviceLike = None,
    ):
        """max_docs: hard cap on the corpus size (0 disables): past ~10^5
        docs the [N, V] layout costs ~100 KB per doc."""
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.quantize_int8 = quantize_int8
        self.batch_pad = batch_pad
        self.max_docs = max_docs
        self.doc_ids: List[str] = []
        self.nnz = 0
        # staged CSR, densified once into the final-dtype build buffer
        self._docs: List[Tuple[np.ndarray, np.ndarray]] = []
        self._mat = None     # device [N_pad, V]
        self._scale = None   # device [N_pad] (int8) or 1.0
        self._n_pad = 0

    # ---------------------------------------------------------- build
    def add(self, doc_id: str, indices: np.ndarray, values: np.ndarray) -> None:
        if self.max_docs and len(self.doc_ids) >= self.max_docs:
            raise ValueError(
                f"ImpactIndex is capped at {self.max_docs} docs (dense "
                f"[N, {self.vocab_size}] layout); use PostingsIndex for "
                "larger corpora, or raise max_docs explicitly")
        idx = np.asarray(indices, np.int32)
        self.doc_ids.append(doc_id)
        self.nnz += len(idx)
        self._docs.append((idx, np.asarray(values, np.float32)))
        self._mat = None

    def add_batch(self, doc_ids: Sequence[str],
                  vecs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        # validate the cap first: a partial batch must not be ingested
        if (self.max_docs
                and len(self.doc_ids) + len(doc_ids) > self.max_docs):
            raise ValueError(
                f"add_batch of {len(doc_ids)} docs would exceed the "
                f"{self.max_docs}-doc cap ({len(self.doc_ids)} present); "
                "nothing was added")
        for did, (idx, val) in zip(doc_ids, vecs):
            self.add(did, idx, val)

    def delete(self, doc_ids: Sequence[str]) -> int:
        """Physically drop documents (the matrix rebuilds on any mutation)."""
        want = set(doc_ids)
        keep = [i for i, d in enumerate(self.doc_ids) if d not in want]
        removed = len(self.doc_ids) - len(keep)
        if removed:
            self.doc_ids = [self.doc_ids[i] for i in keep]
            self._docs = [self._docs[i] for i in keep]
            self.nnz = int(sum(len(idx) for idx, _ in self._docs))
            self._mat = None
        return removed

    def update(self, doc_id: str, indices: np.ndarray,
               values: np.ndarray) -> None:
        self.delete([doc_id])
        self.add(doc_id, indices, values)

    def build(self) -> None:
        """Densify the staged CSR into a final-dtype buffer padded to 128
        rows and upload it."""
        n = len(self._docs)
        if n == 0:
            raise ValueError("empty index")
        self._n_pad = _round_up(n, 128)
        if self.quantize_int8:
            # per-row scales: robust to heterogeneous doc magnitudes
            host = np.zeros((self._n_pad, self.vocab_size), np.int8)
            scale = np.full(self._n_pad, 1.0, np.float32)
            for i, (idx, val) in enumerate(self._docs):
                s = max(float(np.abs(val).max(initial=0.0)), 1e-6) / 127.0
                scale[i] = s
                host[i, idx] = np.clip(np.round(val / s), -127, 127)
            self._mat = torch.from_numpy(host).to(self.device)
            self._scale = torch.from_numpy(scale).to(self.device)
        else:
            mat = torch.zeros((self._n_pad, self.vocab_size),
                              dtype=self.dtype)
            for i, (idx, val) in enumerate(self._docs):
                mat[i, torch.from_numpy(idx).long()] = torch.from_numpy(
                    val).to(self.dtype)
            self._mat = mat.to(self.device)
            self._scale = 1.0
        logger.info("impact index: %d docs (%d padded) x %d dims on %s "
                    "(%s%.0f MB)", n, self._n_pad, self.vocab_size,
                    self.device, "int8, " if self.quantize_int8 else "",
                    self.memory_bytes / 1e6)

    # ---------------------------------------------------------- search
    def device_arrays(self):
        """(mat [N_pad, V], scale [N_pad] or 1.0, n_valid): for callers
        fusing their own compute with the index (the serving engine)."""
        if self._mat is None:
            self.build()
        return self._mat, self._scale, len(self.doc_ids)

    def __len__(self) -> int:
        return len(self.doc_ids)

    @property
    def memory_bytes(self) -> int:
        if self._mat is None:
            return 0
        return self._mat.numel() * self._mat.element_size()
