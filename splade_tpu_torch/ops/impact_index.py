"""Dense impact index on the device.

Counterpart of ``splade_tpu/ops/impact_index.py::TpuImpactIndex``: the
corpus is a dense [N, V] matrix (bf16, f32 or int8 with per-row scales)
and a query batch is scored by one [B, V] x [V, N] matrix product plus
top-k. That product is a plain large matrix product, which the reference
leaves to XLA, so it is ``torch.matmul`` here (f32 accumulation of the
bf16-rounded operands, as the reference's dot_general). Right to a few
10^5 docs; ``PostingsIndex`` serves larger corpora.

With a ``DeviceMesh`` of more than one device the rows are padded to
``128·D`` and cut into D contiguous row shards, each with its int8 scales
on its own device; a search scores and ranks each shard on its device and
merges the partial top-ks on ``mesh.devices[0]`` (the exact top-k, as the
reference's sharded top-k under GSPMD).
"""

from __future__ import annotations

import logging
from typing import List, Sequence, Tuple

import numpy as np
import torch

from splade_tpu_torch.ops.postings_index import on_shard_device
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
    of ``TpuImpactIndex``, with its batched, single-query and two-phase
    search, on one device or row-sharded over a mesh)."""

    def __init__(
        self,
        vocab_size: int,
        dtype: str = "bfloat16",
        quantize_int8: bool = False,
        batch_pad: int = 8,
        mesh=None,
        max_docs: int = 100_000,
        device: DeviceLike = None,
    ):
        """mesh: an optional ``DeviceMesh``; with more than one device the
        corpus rows are sharded over it (a mesh of one device is no mesh)
        and the index lives on ``mesh.devices[0]``. max_docs: hard cap on
        the corpus size a device (0 disables): past ~10^5 docs the [N, V]
        layout costs ~100 KB per doc."""
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.quantize_int8 = quantize_int8
        self.batch_pad = batch_pad
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.max_docs = max_docs * (self.mesh.size if self.mesh else 1)
        self.doc_ids: List[str] = []
        self.nnz = 0
        # staged CSR, densified once into the final-dtype build buffer
        self._docs: List[Tuple[np.ndarray, np.ndarray]] = []
        self._mat = None     # device [N_pad, V]; a mesh: one row shard each
        self._scale = None   # device [N_pad] (int8) or 1.0; likewise
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
        rows (128·D on a mesh) and upload it, a row shard a device."""
        n = len(self._docs)
        if n == 0:
            raise ValueError("empty index")
        D = self.mesh.size if self.mesh else 1
        self._n_pad = _round_up(n, 128 * D)
        if self.quantize_int8:
            # per-row scales: robust to heterogeneous doc magnitudes
            host = np.zeros((self._n_pad, self.vocab_size), np.int8)
            scale = np.full(self._n_pad, 1.0, np.float32)
            for i, (idx, val) in enumerate(self._docs):
                s = max(float(np.abs(val).max(initial=0.0)), 1e-6) / 127.0
                scale[i] = s
                host[i, idx] = np.clip(np.round(val / s), -127, 127)
            mat, scale = torch.from_numpy(host), torch.from_numpy(scale)
        else:
            mat = torch.zeros((self._n_pad, self.vocab_size),
                              dtype=self.dtype)
            for i, (idx, val) in enumerate(self._docs):
                mat[i, torch.from_numpy(idx).long()] = torch.from_numpy(
                    val).to(self.dtype)
            scale = None
        if self.mesh is None:
            self._mat = mat.to(self.device)
            self._scale = 1.0 if scale is None else scale.to(self.device)
        else:
            rows = self._n_pad // D
            self._mat = tuple(mat[d * rows:(d + 1) * rows].to(dev)
                              for d, dev in enumerate(self.mesh.devices))
            self._scale = tuple(
                1.0 if scale is None else scale[d * rows:(d + 1) * rows].to(dev)
                for d, dev in enumerate(self.mesh.devices))
        logger.info("impact index: %d docs (%d padded) x %d dims on %s "
                    "(%s%.0f MB)", n, self._n_pad, self.vocab_size,
                    self.device, "int8, " if self.quantize_int8 else "",
                    self.memory_bytes / 1e6)

    # ---------------------------------------------------------- search
    def search_batch_dense(self, queries: np.ndarray, k: int = 10
                           ) -> List[List[Tuple[str, float]]]:
        """[B, V] dense impact vectors -> per-query ranked lists: the
        batch padded to ``batch_pad`` rows, ``impact_scores`` on the index's
        device, padded corpus rows at -inf, exact top-k; non-finite entries
        are dropped, so a list holds at most len(self) results."""
        queries = np.asarray(queries, np.float32)
        B = queries.shape[0]
        q = np.zeros((_round_up(max(B, 1), self.batch_pad), self.vocab_size),
                     np.float32)
        q[:B] = queries
        with torch.no_grad():
            vals, idxs = self.score_topk(torch.from_numpy(q).to(self.device),
                                         k)
        vals, idxs = vals.cpu().numpy()[:B], idxs.cpu().numpy()[:B]
        return [[(self.doc_ids[int(i)], float(v))
                 for v, i in zip(vals[b], idxs[b]) if np.isfinite(v)]
                for b in range(B)]

    def score_topk(self, queries: torch.Tensor, k: int):
        """[B, V] queries on the index's device -> the exact top-k (scores
        [B, k'], row ids [B, k']), k' = min(k, padded rows), padded rows at
        -inf. On a mesh each row shard is scored and ranked on its own
        device (``on_shard_device``), and the partial top-ks merge here."""
        mat, scale, n_valid = self.device_arrays()
        if self.mesh is None:
            scores = impact_scores(queries, mat, scale, self.quantize_int8)
            scores[:, n_valid:] = float("-inf")
            return torch.topk(scores, min(k, scores.shape[1]), dim=1)
        rows = self._n_pad // self.mesh.size
        k_local = min(k, rows)
        vals, idxs = [], []
        for d, dev in enumerate(self.mesh.devices):
            with on_shard_device(dev):
                scores = impact_scores(queries.to(dev), mat[d], scale[d],
                                       self.quantize_int8)
                scores[:, max(n_valid - d * rows, 0):] = float("-inf")
                v, i = torch.topk(scores, k_local, dim=1)
            vals.append(v.to(self.device))
            idxs.append(i.to(self.device) + d * rows)
        v, pos = torch.topk(torch.cat(vals, 1), min(k, self._n_pad), dim=1)
        return v, torch.cat(idxs, 1).gather(1, pos)

    def search_vector(self, indices: np.ndarray, values: np.ndarray,
                      k: int = 10) -> List[Tuple[str, float]]:
        """One sparse query, (term ids, weights)."""
        q = np.zeros((1, self.vocab_size), np.float32)
        q[0, np.asarray(indices, np.int64)] = np.asarray(values, np.float32)
        return self.search_batch_dense(q, k)[0]

    def search_dense(self, vec: np.ndarray, k: int = 10,
                     query_top_k: int = 0) -> List[Tuple[str, float]]:
        """One dense [V] query; ``query_top_k`` > 0 keeps only its strongest
        positive weights."""
        vec = np.asarray(vec, np.float32)
        if query_top_k:
            nz = np.flatnonzero(vec > 0)
            if len(nz) > query_top_k:
                drop = nz[np.argpartition(-vec[nz],
                                          query_top_k - 1)[query_top_k:]]
                vec = vec.copy()
                vec[drop] = 0.0
        return self.search_batch_dense(vec[None], k)[0]

    def search_two_phase(self, indices: np.ndarray, values: np.ndarray,
                         k: int = 10, prune_ratio: float = 0.4,
                         expansion: float = 5.0) -> List[Tuple[str, float]]:
        """Two-phase pruned search, the reference's rule (after OpenSearch's
        ``neural_sparse_two_phase_processor``): phase 1 ranks ``k *
        expansion`` candidates with only the query terms whose weight is at
        least ``prune_ratio`` times the largest; phase 2 keeps those
        candidates, in the order a full-query search of ``4 *`` that many
        gives them, and returns the first k."""
        indices = np.asarray(indices, np.int64)
        values = np.asarray(values, np.float32)
        if len(values) == 0:
            return []
        keep = values >= prune_ratio * values.max()
        k1 = int(min(max(k * expansion, k), max(len(self.doc_ids), 1)))
        phase1 = self.search_vector(indices[keep], values[keep], k=k1)
        if not phase1:
            return []
        cand = {d for d, _ in phase1}
        full = self.search_vector(indices, values,
                                  k=min(len(self.doc_ids), k1 * 4))
        return [(d, s) for d, s in full if d in cand][:k]

    def device_arrays(self):
        """(mat [N_pad, V], scale [N_pad] or 1.0, n_valid); on a mesh, mat
        and scale are tuples of the row shards."""
        if self._mat is None:
            self.build()
        return self._mat, self._scale, len(self.doc_ids)

    def __len__(self) -> int:
        return len(self.doc_ids)

    @property
    def memory_bytes(self) -> int:
        if self._mat is None:
            return 0
        mats = self._mat if self.mesh else (self._mat,)
        return sum(m.numel() * m.element_size() for m in mats)
