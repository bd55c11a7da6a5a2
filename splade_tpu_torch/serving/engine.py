"""Fused encode→search engine, single device.

Counterpart of ``splade_tpu/serving/engine.py``. One search batch runs
ModernBERT encode → banned-token zeroing → query top-k → index scoring →
top-k docs on the device; only token ids go up and [B, k] (doc index,
score) pairs come back. The reference jit-compiles each (batch bucket,
k tier) shape; PyTorch runs eagerly, so the buckets and tiers here keep
the set of shapes small for the kernels and the allocator.

Backends: the dense ``ImpactIndex`` and the (two-phase) ``PostingsIndex``.
The tiered, cluster and mesh-sharded backends wait (ROADMAP.md §1).
"""

from __future__ import annotations

import logging
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
from splade_tpu_torch.ops.impact_index import ImpactIndex, impact_scores
from splade_tpu_torch.ops.postings_index import (PostingsIndex,
                                                 postings_score_topk,
                                                 postings_two_phase_topk)
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device
from splade_tpu_torch.utils.text import quantize_to_tier

logger = logging.getLogger(__name__)


def _bucket_batch(n: int, pad: int) -> int:
    """Power-of-two bucketing above ``pad``: {pad, 2·pad, 4·pad, ...}."""
    b = pad
    while b < n:
        b *= 2
    return b


def _encode_sparse(model, banned, ids, mask) -> torch.Tensor:
    repr_ = model(ids, mask)[0].to(torch.float32)                  # [B, V]
    if banned is not None:
        repr_ = repr_.masked_fill(banned[None, :], 0.0)
    return repr_


def make_fused_search_fn(model, banned, query_top_k: int, is_int8: bool):
    """Fused encode→dense-search fn shared by ServingEngine and benches:
    (mat, scale, ids, mask, n_valid, k) -> (scores [B,k], doc_indices [B,k])."""

    def fused_search(mat, scale, ids, mask, n_valid, k):
        repr_ = _encode_sparse(model, banned, ids, mask)
        if query_top_k:
            # keep the query_top_k strongest activations per query
            thr = torch.topk(repr_, query_top_k, dim=1).values[:, -1:]
            repr_ = torch.where(repr_ >= thr.clamp_min(1e-9), repr_,
                                torch.zeros_like(repr_))
        scores = impact_scores(repr_, mat, scale, is_int8)
        scores[:, n_valid:] = float("-inf")
        return torch.topk(scores, k, dim=1)

    return fused_search


def _make_encode_query(model, banned, top_t: int):
    """Query encode shared by the postings paths: forward, banned-token
    zeroing, top-T -> ([B, T] vals, [B, T] ids)."""

    def encode_query(ids, mask):
        return torch.topk(_encode_sparse(model, banned, ids, mask), top_t,
                          dim=1)

    return encode_query


def make_fused_postings_search_fn(model, banned, top_t: int, n_docs: int,
                                  approx: bool = True, vocab_size: int = 0,
                                  n_candidates: int = 0, acc_dtype=None,
                                  scoring: str = "scatter"):
    """Fused encode→postings-search for PostingsIndex-backed serving.

    Single-phase (n_candidates=0): (post_docs, post_w, term_scale, ids,
    mask, k). Two-phase: (post_docs, post_w, term_scale, d_terms, d_vals,
    d_scale, ids, mask, k). Both -> (scores, doc_indices, q_val, q_idx);
    the query vectors ride along for the LSM-delta merge."""
    encode_query = _make_encode_query(model, banned, top_t)

    if n_candidates:
        def fused2(post_docs, post_w, term_scale, d_terms, d_vals, d_scale,
                   ids, mask, k):
            q_val, q_idx = encode_query(ids, mask)
            vals, idxs = postings_two_phase_topk(
                post_docs, post_w, term_scale, d_terms, d_vals, d_scale,
                q_idx, q_val, k, n_docs, vocab_size, n_candidates, approx,
                phase1_dtype=acc_dtype, scoring=scoring)
            return vals, idxs, q_val, q_idx

        return fused2

    def fused(post_docs, post_w, term_scale, ids, mask, k):
        q_val, q_idx = encode_query(ids, mask)
        vals, idxs = postings_score_topk(post_docs, post_w, term_scale,
                                         q_idx, q_val, k, n_docs, approx,
                                         acc_dtype=acc_dtype,
                                         scoring=scoring)
        return vals, idxs, q_val, q_idx

    return fused


class ServingEngine:
    """Owns the model on the device and a built index.

    Counterpart of ``splade_tpu.serving.engine.ServingEngine``;
    query_top_k mirrors the reference's top-64 rank_feature clause cap."""

    def __init__(
        self,
        model,
        tokenizer,
        index,
        query_max_length: int = 64,
        query_top_k: int = 64,
        batch_pad: int = 8,
        max_k: int = 100,
        k_tiers: Sequence[int] = (10, 100),
        delta_compact_threshold: int = 1024,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if index.device != self.device:
            raise ValueError(f"index lives on {index.device}, the engine "
                             f"on {self.device}")
        self.tokenizer = tokenizer
        self.index = index
        self.query_max_length = query_max_length
        self.batch_pad = batch_pad
        self.max_k = max_k
        self.k_tiers = tuple(sorted(k_tiers))
        self.delta_compact_threshold = delta_compact_threshold
        # CRUD and search touch shared index state from different threads
        # (HTTP handlers vs the batcher): one lock makes mutation plus the
        # host side of search atomic
        self._index_lock = threading.RLock()
        # reused for /encode and for indexing new documents
        self.encoder = SparseEncoderV33(
            model, tokenizer, query_max_length=query_max_length,
            query_top_k=query_top_k, device=self.device)
        self._model = self.encoder.model
        self._banned = self.encoder.banned
        self._postings = isinstance(index, PostingsIndex)
        if self._postings:
            self._build_postings_fused()
        elif isinstance(index, ImpactIndex):
            self._fused = make_fused_search_fn(
                self._model, self._banned, query_top_k,
                is_int8=index.quantize_int8)
        else:
            raise NotImplementedError(
                f"{type(index).__name__} is not served by this slice "
                "(tiered, cluster and mesh indexes: ROADMAP.md §1)")

    def _build_postings_fused(self) -> None:
        """(Re)build the fused postings fn: the accumulator width is the
        doc count, so a mutated base segment needs a new fn."""
        if self.index._built is None:
            self.index.build()
        self._postings_n = len(self.index)
        C = min(self.index.rescore_candidates, self._postings_n)
        self._postings_two_phase = bool(C)
        self._postings_C = self.index.max_results() if C else 0
        self._fused = make_fused_postings_search_fn(
            self._model, self._banned, top_t=self.index.query_top_t,
            n_docs=self._postings_n, approx=self.index.approx,
            vocab_size=self.index.vocab_size, n_candidates=C,
            acc_dtype=self.index.acc_dtype(),
            scoring=self.index.resolved_scoring())

    # ------------------------------------------------------------- search
    def _quantize_k(self, k: int) -> int:
        """Round k up to a fixed tier and slice on the host."""
        k = min(max(k, 1), self.max_k, len(self.index))
        return quantize_to_tier(k, self.k_tiers, cap=len(self.index))

    def search_batch(
        self, queries: Sequence[str], k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        """Encode + retrieve a batch of query strings in one fused pass."""
        with self._index_lock, torch.no_grad():
            return self._search_batch_locked(queries, k)

    def _search_batch_locked(
        self, queries: Sequence[str], k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        if len(self.index) == 0:
            return [[] for _ in queries]
        if self._postings:
            if self.index._built is None:
                self._build_postings_fused()
            elif self.index.delta_count or self.index.deleted_count:
                # LSM path: small deltas are scored on the host and merged,
                # deletes are tombstone-filtered; past the threshold, or
                # once deletes approach max_k (the over-fetch is clamped
                # there), compact once
                delete_cap = min(self.delta_compact_threshold,
                                 max(self.max_k // 2, 1))
                if (self.index.delta_count + self.index.deleted_count
                        > self.delta_compact_threshold
                        or self.index.deleted_count > delete_cap):
                    self.index.compact()
                    if len(self.index):
                        self._build_postings_fused()
            elif len(self.index) != self._postings_n:
                self._build_postings_fused()
        if len(self.index) == 0:
            return [[] for _ in queries]
        deleted = getattr(self.index, "deleted_count", 0)
        live = len(self.index) - deleted
        if live <= 0:
            return [[] for _ in queries]
        # clamp k to the live doc count: more is unsatisfiable
        k = min(max(k, 1), self.max_k, live)
        # fetch ceiling of the current fused fn: the base segment size,
        # further clamped to the candidate pool in two-phase mode
        fetch_cap = self.max_k
        if self._postings:
            fetch_cap = min(fetch_cap, self._postings_n)
            if self._postings_two_phase:
                fetch_cap = min(fetch_cap, self._postings_C)
        if self._postings and deleted and k + deleted > fetch_cap:
            # the over-fetch cannot cover the tombstones for this k: one
            # synchronous compaction for a hard k-results guarantee
            self.index.compact()
            self._build_postings_fused()
            deleted = 0
            fetch_cap = min(self.max_k, self._postings_n)
            if self._postings_two_phase:
                fetch_cap = min(fetch_cap, self._postings_C)
        k_eff = self._quantize_k(min(k + deleted, fetch_cap))
        if self._postings:
            # tier rounding may exceed the fused fn's width: clamp the
            # device fetch; the delta merge below tops results up
            k_eff = min(k_eff, fetch_cap)
            if self._postings_two_phase:
                k = min(k, self._postings_C)
        B = len(queries)
        padded = list(queries) + [""] * (
            _bucket_batch(max(B, 1), self.batch_pad) - B)
        ids, mask = self.encoder.tokenize(padded, self.query_max_length)
        q_cached = None
        if self._postings:
            if self._postings_two_phase:
                vals, idxs, q_val, q_idx = self._fused(
                    *self.index._built, *self.index._doc_major, ids, mask,
                    k_eff)
            else:
                vals, idxs, q_val, q_idx = self._fused(
                    *self.index._built, ids, mask, k_eff)
            q_cached = q_val, q_idx
        else:
            mat, scale, n_valid = self.index.device_arrays()
            vals, idxs = self._fused(mat, scale, ids, mask, n_valid, k_eff)
        vals = vals.float().cpu().numpy()[:B]
        idxs = idxs.cpu().numpy()[:B]
        doc_ids = self.index.doc_ids
        # dense pads rows with -inf; postings no-overlap docs score 0: both
        # are non-results. Tombstoned docs are filtered here.
        tomb = getattr(self.index, "_tombstones", None) or frozenset()
        keep = ((lambda v, i: v > 0 and i not in tomb) if self._postings
                else (lambda v, i: np.isfinite(v)))
        out = [[(doc_ids[int(i)], float(v))
                for v, i in zip(vals[b], idxs[b]) if keep(v, int(i))][:k]
               for b in range(B)]
        if self._postings and self.index.delta_count:
            # the fused fn already computed the top-T query vectors
            q_val = q_cached[0].cpu().numpy()[:B]
            q_idx = q_cached[1].cpu().numpy()[:B]
            d_scores = self.index.score_delta(list(q_idx), list(q_val))
            out = self.index.merge_delta(out, d_scores, k)
        return out

    def warmup(self, max_batch_size: int = 32) -> int:
        """Run every (batch bucket, k tier) shape the server can hit once,
        so kernels are built and the allocator is warm before the first
        request. Returns the number of shapes run."""
        shapes = 0
        b = self.batch_pad
        buckets = []
        while b < max_batch_size:
            buckets.append(b)
            b *= 2
        buckets.append(b)
        for bucket in buckets:
            for tier in self.k_tiers:
                self.search_batch([""] * bucket, k=min(tier, len(self.index)))
                shapes += 1
        logger.info("warmed %d fused-search shapes (buckets %s x k tiers %s)",
                    shapes, buckets, list(self.k_tiers))
        return shapes

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        return self.search_batch([query], k)[0]

    # ------------------------------------------------------------- encode
    def encode(self, texts: Sequence[str], queries: bool = False):
        """Sparse vectors [(indices, values), ...] for external indexing."""
        if queries:
            return self.encoder.encode_queries(list(texts))
        return self.encoder.encode_documents(list(texts))

    # --------------------------------------------------------- index CRUD
    def add_documents(self, docs: Sequence[Tuple[str, str]]) -> int:
        """Encode and index (doc_id, text) pairs live (postings backends
        serve them from the LSM delta)."""
        vecs = self.encoder.encode_documents([t for _, t in docs])
        with self._index_lock:
            self.index.add_batch([d for d, _ in docs], vecs)
        return len(docs)

    def delete_documents(self, doc_ids: Sequence[str]) -> int:
        """Tombstone documents (the dense backend drops rows)."""
        with self._index_lock:
            return self.index.delete(doc_ids)

    @property
    def num_docs(self) -> int:
        return len(self.index)


def build_engine_from_docs(
    model, tokenizer,
    docs: Sequence[Tuple[str, str]],
    int8: bool = True,
    doc_top_k: int = 0,
    index_type: str = "dense",
    n_postings: Optional[int] = None,
    rescore_candidates: Optional[int] = None,
    posting_scoring: str = "auto",
    device: DeviceLike = None,
    **engine_kw,
) -> ServingEngine:
    """Encode (doc_id, text) pairs on the device and build a served index.

    index_type: 'dense' ([N, V] matrix index, to a few 10^5 docs) or
    'postings' (truncated postings; rescore_candidates > 0 adds the
    two-phase exact rescore, paired with a short cap such as
    n_postings=64). 'tiered' and 'cluster' wait (ROADMAP.md §1)."""
    if index_type in ("tiered", "cluster"):
        raise NotImplementedError(
            f"index_type={index_type!r} is not ported yet: the "
            f"{index_type} index is queued in ROADMAP.md §1")
    dev = resolve_device(device)
    enc = SparseEncoderV33(model, tokenizer, doc_top_k=doc_top_k, device=dev)
    if index_type == "postings":
        index = PostingsIndex(
            len(tokenizer),
            n_postings=2048 if n_postings is None else n_postings,
            query_top_t=engine_kw.get("query_top_k", 64) or 32,
            rescore_candidates=rescore_candidates or 0,
            scoring=posting_scoring, device=dev)
    elif index_type == "dense":
        index = ImpactIndex(len(tokenizer), quantize_int8=int8, device=dev)
    else:
        raise ValueError(f"index_type {index_type!r}")
    vecs = enc.encode_documents([t for _, t in docs])
    index.add_batch([d for d, _ in docs], vecs)
    index.build()
    return ServingEngine(enc.model, tokenizer, index, device=dev, **engine_kw)
