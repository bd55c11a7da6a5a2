"""DF-tiered postings: per-term posting budgets at rectangular shapes.

Counterpart of ``splade_tpu/ops/tiered_postings.py``. Uniform truncation
keeps under 1% of a hot term's list; fully variable per-term lists are
ragged. This index keeps two rectangular tiers instead:

- **cold tier** ``[V, P_cold]``: every term's top-``P_cold`` postings
  (identical to the uniform index),
- **hot tier** ``[H, P_hot]``: for the ``H`` highest-df terms that
  overflow the cold tier, the continuation of their impact-ordered list
  (ranks ``P_cold .. P_cold + P_hot``), reached through a ``hot_slot [V]``
  remap whose pad row (slot ``H``) is all zero for cold terms.

A hot term's depth is ``P_cold + P_hot`` while memory stays
``V * P_cold + H * P_hot``. Both tiers are plain 2-D gathers that feed the
uniform index's aggregations (scatter / sort / select / select_sum), and
two-phase search re-scores the candidates exactly through the shared
phase 2 (``dispatch_rescore``: the Hopper rescore kernel on the card).
``MeshShardedTieredPostingsIndex`` shards the documents over a
``DeviceMesh`` as ``MeshShardedPostingsIndex`` does, each shard with tiers
of its own.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from splade_tpu_torch.ops.postings_index import (
    DocSharded, PostingsIndex, _select_sum_topk, _select_topk_candidates,
    _sorted_segment_topk, dispatch_rescore, flatten_csr, invert_flat,
    merge_sharded_topk, quantize_postings, search_shards)
from splade_tpu_torch.utils.runtime import DeviceLike

logger = logging.getLogger(__name__)

_NEG_INF = float("-inf")


def select_hot_terms(df: np.ndarray, p_cold: int, hot_terms: int
                     ) -> np.ndarray:
    """Term ids that get a hot-tier row: the ``hot_terms`` highest-df
    terms among those that overflow the cold tier (df > p_cold). May
    return fewer than ``hot_terms`` ids."""
    over = np.flatnonzero(df > p_cold)
    if len(over) > hot_terms:
        top = np.argpartition(-df[over], hot_terms - 1)[:hot_terms]
        over = over[top]
    return np.sort(over).astype(np.int32)


def build_tiered(doc_idx, doc_val, vocab_size: int, p_cold: int,
                 hot_terms: int, p_hot: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                            np.ndarray, np.ndarray, int]:
    """Both tiers from per-doc CSR lists.

    Returns (cold_docs [V,Pc] i32, cold_w [V,Pc] f32,
             hot_slot [V] i32 (== H for cold terms),
             hot_docs [H,Ph] i32, hot_w [H,Ph] f32, n_truncated).
    H is the realized hot count (<= hot_terms); all-zero rows pad terms
    whose list ends inside the hot window."""
    all_terms, all_vals, all_docs = flatten_csr(doc_idx, doc_val)
    df = np.bincount(all_terms, minlength=vocab_size)
    cold_docs, cold_w, trunc_cold = invert_flat(
        all_terms, all_vals, all_docs, vocab_size, p_cold)
    hot_ids = select_hot_terms(df, p_cold, hot_terms)
    H = len(hot_ids)
    hot_slot = np.full(vocab_size, H, np.int32)
    if H == 0:
        return (cold_docs, cold_w, hot_slot,
                np.zeros((0, p_hot), np.int32),
                np.zeros((0, p_hot), np.float32), trunc_cold)
    hot_slot[hot_ids] = np.arange(H, dtype=np.int32)
    # invert only the hot terms' postings, remapped to [0, H), at depth
    # P_cold + P_hot; the hot tier keeps the continuation slice
    is_hot = hot_slot[all_terms] < H
    full_docs, full_w, _ = invert_flat(
        hot_slot[all_terms[is_hot]], all_vals[is_hot], all_docs[is_hot],
        max(H, 1), p_cold + p_hot)
    hot_docs = np.ascontiguousarray(full_docs[:, p_cold:])
    hot_w = np.ascontiguousarray(full_w[:, p_cold:])
    # a hot term's postings past P_cold live in the hot tier: truncated
    # only past P_cold + P_hot
    kept_by_hot = int((hot_w > 0).sum())
    return (cold_docs, cold_w, hot_slot, hot_docs, hot_w,
            trunc_cold - kept_by_hot)


def tiered_score_topk(cold_docs, cold_w, cold_scale, hot_slot, hot_docs,
                      hot_w, hot_scale, q_idx, q_val, k: int, n_docs: int,
                      approx: bool, acc_dtype=None, scoring: str = "sort"):
    """Tiered analogue of ``postings_score_topk``: gather both tiers' rows
    for the query terms, aggregate them together ([B, T, P_cold + P_hot]),
    top-k. The hot gather goes through ``hot_slot``: cold terms hit the
    all-zero pad row (slot H) and add nothing. Returns (scores [B, k],
    doc ids [B, k] int64)."""
    if acc_dtype is None:
        acc_dtype = torch.float32
    qi = q_idx.long()
    qv = q_val.to(torch.float32)
    slot = hot_slot[qi].long()                                  # [B, T]
    tiers = ((cold_docs[qi].long(), cold_w[qi], qv * cold_scale[qi]),
             (hot_docs[slot].long(), hot_w[slot], qv * hot_scale[slot]))
    if scoring == "scatter":
        B = qi.shape[0]
        acc = torch.zeros((B, n_docs), dtype=acc_dtype, device=qi.device)
        for rows, w8, qw in tiers:
            contrib = (w8.to(torch.bfloat16)
                       * qw[:, :, None].to(torch.bfloat16))
            acc.scatter_add_(1, rows.reshape(B, -1),
                             contrib.reshape(B, -1).to(acc_dtype))
        return torch.topk(acc, k, dim=1)
    rows_d = torch.cat([rows for rows, _, _ in tiers], dim=2)
    contrib = torch.cat([w8.to(torch.float32) * qw[:, :, None]
                         for _, w8, qw in tiers], dim=2)
    if scoring == "select":
        return _select_topk_candidates(rows_d, contrib, k, approx)
    if scoring == "select_sum":
        return _select_sum_topk(rows_d, contrib, k, approx)
    return _sorted_segment_topk(rows_d, contrib, k)


def tiered_two_phase_topk(cold_docs, cold_w, cold_scale, hot_slot,
                          hot_docs, hot_w, hot_scale, d_terms, d_vals,
                          d_scale, q_idx, q_val, k: int, n_docs: int,
                          vocab_size: int, n_candidates: int, approx: bool,
                          phase1_dtype=None, scoring: str = "sort",
                          rescore: str = "auto"):
    """Two-phase search with a tiered phase 1 and the shared exact phase-2
    rescore (the contract of ``postings_two_phase_topk``)."""
    if phase1_dtype is None:
        phase1_dtype = torch.bfloat16
    p1_vals, cand = tiered_score_topk(
        cold_docs, cold_w, cold_scale, hot_slot, hot_docs, hot_w,
        hot_scale, q_idx, q_val, n_candidates, n_docs, approx,
        acc_dtype=phase1_dtype, scoring=scoring)
    scores = dispatch_rescore(d_terms, d_vals, d_scale, q_idx, q_val, cand,
                              vocab_size, mode=rescore)
    # filler slots (val -inf, id 0) must not resurface as doc 0
    scores = torch.where(p1_vals == _NEG_INF,
                         torch.full_like(scores, _NEG_INF), scores)
    vals, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return vals, cand.gather(1, pos)


def make_mesh_tiered_search_fns(mesh, shard_size: int, n_docs: int,
                                vocab_size: int, n_candidates: int,
                                approx: bool, acc_dtype, scoring: str):
    """Search bodies of doc-sharded TIERED postings: the contract of
    ``make_mesh_postings_search_fns`` with the 7-array tiered phase 1 a
    shard (then its doc-major block when two-phase)."""
    per, n, V, C = shard_size, n_docs, vocab_size, n_candidates

    def search(shards, q_idx, q_val, k):
        k_local = min(k, per)

        def shard_search(cd, cw, cs, hs, hd, hw, hsc, qi, qv):
            return tiered_score_topk(cd, cw, cs, hs, hd, hw, hsc, qi, qv,
                                     k_local, per, approx,
                                     acc_dtype=acc_dtype, scoring=scoring)

        vals, idxs = search_shards(mesh.devices, shards, shard_search,
                                   q_idx, q_val)
        return merge_sharded_topk(vals, idxs, k, per, n)

    def search_two_phase(shards, q_idx, q_val, k):
        k_local = min(k, per, C)

        def shard_search(cd, cw, cs, hs, hd, hw, hsc, dt, dv, dsc, qi, qv):
            return tiered_two_phase_topk(
                cd, cw, cs, hs, hd, hw, hsc, dt, dv, dsc, qi, qv, k_local,
                per, V, C, approx, phase1_dtype=acc_dtype, scoring=scoring)

        vals, idxs = search_shards(mesh.devices, shards, shard_search,
                                   q_idx, q_val)
        return merge_sharded_topk(vals, idxs, k, per, n)

    return search, search_two_phase


class TieredPostingsIndex(PostingsIndex):
    """Two-tier DF-budgeted postings index (see the module docstring).

    Counterpart of ``splade_tpu.ops.tiered_postings.TieredPostingsIndex``.
    Knobs over ``PostingsIndex``: ``hot_terms`` (max hot rows H) and
    ``hot_postings`` (the hot tier's continuation depth P_hot). With no
    term overflowing the cold tier it has the uniform index's structure
    (and keeps this class's search path). ``_built`` holds the seven
    phase-1 arrays (cold docs, cold int8 weights, cold scales, hot slots,
    hot docs with the pad row, hot int8 weights, hot scales)."""

    _SAVE_KIND = "tiered"

    def __init__(self, vocab_size: int, n_postings: int = 256,
                 hot_terms: int = 2048, hot_postings: int = 8192,
                 query_top_t: int = 32, batch_pad: int = 8,
                 approx: bool = True, rescore_candidates: int = 0,
                 phase1_acc: str = "auto", scoring: str = "auto",
                 device: DeviceLike = None):
        super().__init__(vocab_size, n_postings=n_postings,
                         query_top_t=query_top_t, batch_pad=batch_pad,
                         approx=approx,
                         rescore_candidates=rescore_candidates,
                         phase1_acc=phase1_acc, scoring=scoring,
                         device=device)
        self.hot_terms = hot_terms
        self.hot_postings = hot_postings
        self.n_hot = 0  # realized H, set at build

    def resolved_scoring(self) -> str:
        """The base rule on the tiered pool E = T * (P_cold + P_hot):
        'sort' up to 4,096 entries, else 'scatter'."""
        if self.scoring != "auto":
            return self.scoring
        E = self.query_top_t * (self.n_postings + self.hot_postings)
        return "sort" if E <= 4096 else "scatter"

    def build(self) -> None:
        n = len(self.doc_ids)
        if n == 0:
            raise ValueError("empty index")
        (cold_docs, cold_w, hot_slot, hot_docs, hot_w,
         self.truncated_postings) = build_tiered(
            self._doc_idx, self._doc_val, self.vocab_size,
            self.n_postings, self.hot_terms, self.hot_postings)
        self.n_hot = H = hot_docs.shape[0]
        cold_q, cold_scale = quantize_postings(cold_w)
        # pad row (slot H): zero weights, unit scale; cold terms route here
        # and add nothing
        pad = np.zeros((1, self.hot_postings), np.float32)
        hot_q, hot_scale = quantize_postings(np.vstack([hot_w, pad]))
        hot_docs_pad = np.vstack([hot_docs, pad.astype(np.int32)])
        dev = self.device
        self._built = tuple(torch.from_numpy(a).to(dev) for a in (
            cold_docs, cold_q, cold_scale, hot_slot, hot_docs_pad, hot_q,
            hot_scale))
        if self.rescore_candidates:
            self._doc_major = self._build_doc_major()
        self._base_n = n
        self._delta_cache = None
        self._make_search()
        logger.info(
            "tiered postings index: %d docs, cold P=%d + hot %d x P=%d "
            "(truncated %.2f%% of postings), %.0f MB on %s",
            n, self.n_postings, H, self.hot_postings,
            100.0 * self.truncated_postings / max(self.nnz, 1),
            self.memory_bytes() / 1e6, dev)

    def _make_search(self) -> None:
        n = len(self.doc_ids)
        V = self.vocab_size
        C = min(self.rescore_candidates, n) if self.rescore_candidates else 0
        acc_dtype = self.acc_dtype()
        scoring = self.resolved_scoring()
        approx = self.approx

        if C:
            def search(q_idx, q_val, k):
                return tiered_two_phase_topk(
                    *self._built, *self._doc_major, q_idx, q_val, k, n, V, C,
                    approx, phase1_dtype=acc_dtype, scoring=scoring)
        else:
            def search(q_idx, q_val, k):
                return tiered_score_topk(
                    *self._built, q_idx, q_val, k, n, approx,
                    acc_dtype=acc_dtype, scoring=scoring)
        self._search_fn = search

    # --------------------------------------------------------- persistence
    def _config_array(self) -> np.ndarray:
        return np.asarray([self.vocab_size, self.n_postings,
                           self.query_top_t, self.rescore_candidates,
                           self.hot_terms, self.hot_postings], np.int64)

    def config_summary(self) -> str:
        return (f"n_postings={self.n_postings} hot={self.n_hot}"
                f"x{self.hot_postings} query_top_t={self.query_top_t} "
                f"rescore={self.rescore_candidates}")

    @classmethod
    def _config_kwargs(cls, cfg: np.ndarray):
        vocab, P, top_t, C, H, Ph = (int(x) for x in cfg)
        return vocab, dict(n_postings=P, query_top_t=top_t,
                           rescore_candidates=C, hot_terms=H,
                           hot_postings=Ph)


class MeshShardedTieredPostingsIndex(DocSharded, TieredPostingsIndex):
    """Doc-sharded DF-tiered postings over a ``DeviceMesh``: each shard
    builds its own tiers (its hot terms follow its own df), searches
    locally, and the [D, B, k] partial top-ks merge on ``mesh.devices[0]``.
    Counterpart of ``splade_tpu``'s class of the same name: hot rows are
    padded to exactly ``hot_terms`` plus the all-zero pad row, and the
    cold-term slot H repointed to ``hot_terms``, so every shard has one
    layout; ``n_hot`` sums the shards' realized hot rows."""

    def __init__(self, vocab_size: int, mesh, n_postings: int = 256,
                 hot_terms: int = 2048, hot_postings: int = 8192,
                 query_top_t: int = 32, batch_pad: int = 8,
                 approx: bool = True, rescore_candidates: int = 0,
                 phase1_acc: str = "auto", scoring: str = "auto"):
        super().__init__(vocab_size, n_postings=n_postings,
                         hot_terms=hot_terms, hot_postings=hot_postings,
                         query_top_t=query_top_t, batch_pad=batch_pad,
                         approx=approx,
                         rescore_candidates=rescore_candidates,
                         phase1_acc=phase1_acc, scoring=scoring,
                         device=mesh.devices[0])
        self._set_mesh(mesh)

    def build(self) -> None:
        n = len(self.doc_ids)
        if n == 0:
            raise ValueError("empty index")
        per, bounds = self._shard_bounds()
        V, Pc, Hmax, Ph = (self.vocab_size, self.n_postings, self.hot_terms,
                           self.hot_postings)
        built = []
        self.truncated_postings = 0
        self.n_hot = 0
        for dev, (lo, hi) in zip(self.mesh.devices, bounds):
            if lo >= hi:  # empty tail shard: every slot at the pad row
                cold_docs = np.zeros((V, Pc), np.int32)
                cold_w = np.zeros((V, Pc), np.float32)
                hot_slot = np.full(V, Hmax, np.int32)
                hot_docs = np.zeros((0, Ph), np.int32)
                hot_w = np.zeros((0, Ph), np.float32)
                trunc = 0
            else:
                (cold_docs, cold_w, hot_slot, hot_docs, hot_w,
                 trunc) = build_tiered(
                    self._doc_idx[lo:hi], self._doc_val[lo:hi], V, Pc,
                    Hmax, Ph)
            H = hot_docs.shape[0]
            self.n_hot += H
            self.truncated_postings += trunc
            # hot rows padded to exactly Hmax (+ the pad row), the cold-term
            # slot H repointed to Hmax
            hot_slot = np.where(hot_slot == H, Hmax, hot_slot)
            pad = Hmax + 1 - H
            hot_docs = np.vstack([hot_docs, np.zeros((pad, Ph), np.int32)])
            hot_w = np.vstack([hot_w, np.zeros((pad, Ph), np.float32)])
            built.append(self._place(
                dev, cold_docs, *quantize_postings(cold_w), hot_slot,
                hot_docs, *quantize_postings(hot_w)))
        self._built = tuple(built)
        self._doc_major = (self._shard_doc_major(bounds, per)
                           if self.rescore_candidates else None)
        self._base_n = n
        self._delta_cache = None
        self._make_search()
        logger.info(
            "mesh tiered index: %d docs over %d shards (%d/shard), cold "
            "P=%d + hot %dx%d/shard, %.0f MB total", n, self.n_shards, per,
            Pc, Hmax, Ph, self.memory_bytes() / 1e6)

    def _make_search(self) -> None:
        per = self._shard_size
        C = min(self.rescore_candidates, per) if self.rescore_candidates else 0
        search, search_two_phase = make_mesh_tiered_search_fns(
            self.mesh, per, len(self.doc_ids), self.vocab_size, C,
            self.approx, self.acc_dtype(), self.resolved_scoring())
        fn = search_two_phase if C else search
        self._search_fn = lambda qi, qv, k: fn(self.shard_arrays(), qi, qv, k)
