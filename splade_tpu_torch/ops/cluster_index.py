"""Cluster-summary sparse index: SEISMIC-style two-level search.

Counterpart of ``splade_tpu/ops/cluster_index.py``. Documents are grouped
into small clusters and each cluster keeps ONE summary vector, the
elementwise max over its members, so

    summary_score(q, c) = sum_t q_t * max_{d in c} d_t
                        >= max_{d in c} score(q, d):

the summary score upper-bounds every member's score with no term
truncation anywhere.

- **Phase 1a (clusters)**: a dense [B, V] x [V, K] product of bf16
  operands into f32 scores (``summary_scores``: one cuBLAS GEMM on the
  card, as the reference's ``jnp.dot`` outside any kernel), exact top-L,
  the L clusters' members -> [B, L*G] candidate ids.
- **Phase 1b (postings)**: short-cap impact-ordered postings (the uniform
  index's phase 1), top-C_p ids.
- **Phase 2**: ONE exact rescore of the union (the shared
  ``dispatch_rescore``: the Hopper rescore kernel on the card), then a
  plain dedup: sort by id, drop neighbours with the id before them, top-k.

Clustering is balanced recursive bisection in random-projection space
(``assign_clusters``), host-side numpy: the same code as the reference, so
its outputs are bitwise the reference's. The doc-major block has one pad
row (doc id n, all pad terms, score exactly 0) that padded cluster slots
point at; the rescore reads it as a row like any other.

CRUD (delta adds, tombstones, compaction), persistence and the search API
come from ``PostingsIndex``; build and phases 1-2 differ.
``MeshShardedClusterIndex`` shards the documents over a ``DeviceMesh``, each
shard with clusters, summaries, a postings side and a doc-major block of
its own, and merges the shards' exact partial top-ks.
"""

from __future__ import annotations

import logging
import time
from typing import Tuple

import numpy as np
import torch

from splade_tpu_torch.ops.postings_index import (
    DocSharded, PostingsIndex, dispatch_rescore, invert_to_postings,
    merge_sharded_topk, postings_score_topk, quantize_postings,
    search_shards, sparse_query_dense)
from splade_tpu_torch.utils.runtime import DeviceLike

logger = logging.getLogger(__name__)

_NEG_INF = float("-inf")


def project_docs(doc_idx, doc_val, vocab_size: int, n_proj: int,
                 seed: int = 0) -> np.ndarray:
    """[N, r] random projection of the sparse doc vectors (host-side,
    chunked). Random directions preserve dot-product geometry in
    expectation, so nearby projections => similar scores for any query."""
    n = len(doc_idx)
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((vocab_size + 1, n_proj)).astype(np.float32)
    proj = np.empty((n, n_proj), np.float32)
    lens = {len(x) for x in doc_idx}
    if len(lens) == 1 and min(lens) >= 1:
        ti, tv = np.stack(doc_idx), np.stack(doc_val)
        step = max(1, (1 << 24) // (ti.shape[1] * n_proj))  # bound temp mem
        for s in range(0, n, step):
            e = min(s + step, n)
            proj[s:e] = np.einsum("dm,dmr->dr", tv[s:e], R[ti[s:e]],
                                  optimize=True)
    else:
        for i, (t_i, t_v) in enumerate(zip(doc_idx, doc_val)):
            proj[i] = t_v @ R[t_i] if len(t_i) else 0.0
    return proj


def assign_clusters(doc_idx, doc_val, cluster_size: int,
                    vocab_size: int | None = None, n_proj: int = 16,
                    seed: int = 0) -> Tuple[np.ndarray, int]:
    """Balanced recursive bisection in random-projection space: each doc
    is projected onto r random directions, and segments are median-split
    along the per-level maximum-spread dimension until every segment fits
    G docs. Balanced by construction (segment sizes differ by <= 1).

    Returns (cluster_of [N] int32, n_clusters)."""
    n = len(doc_idx)
    G = cluster_size
    if vocab_size is None:
        vocab_size = int(max((int(x.max()) for x in doc_idx
                              if len(x)), default=0)) + 1
    proj = project_docs(doc_idx, doc_val, vocab_size, n_proj, seed)

    order = np.arange(n)
    seg = np.zeros(n, np.int64)  # segment id per position in `order`
    sizes = np.array([n], np.int64)
    while sizes.max() > G:
        # per-segment split dim = the projection with the largest spread
        # inside that segment (computed segment-wise via sorted extremes)
        starts = np.r_[0, np.cumsum(sizes)[:-1]]
        p = proj[order]
        hi = np.maximum.reduceat(p, starts, axis=0)
        lo = np.minimum.reduceat(p, starts, axis=0)
        dim = np.argmax(hi - lo, axis=1)           # [n_seg]
        key = p[np.arange(n), dim[seg]]
        ix = np.lexsort((key, seg))
        order, seg = order[ix], seg[ix]
        rank = np.arange(n) - starts[seg]
        half = (sizes[seg] + 1) // 2
        seg = seg * 2 + (rank >= half)
        # renumber segments densely and recompute sizes
        _, seg = np.unique(seg, return_inverse=True)
        sizes = np.bincount(seg)
        # keep `order` grouped by the new seg ids (stable)
        ix = np.argsort(seg, kind="stable")
        order, seg = order[ix], seg[ix]
    cluster_of = np.empty(n, np.int32)
    cluster_of[order] = seg.astype(np.int32)
    return cluster_of, int(sizes.size)


def build_cluster_arrays(doc_idx, doc_val, cluster_of: np.ndarray,
                         n_clusters: int, cluster_size: int, vocab_size: int,
                         pad_doc: int):
    """Summaries + membership, host-side and vectorized.

    Returns (summary [V, K] float32, the elementwise max over members;
    cluster_docs [K, G] int32 padded with ``pad_doc``)."""
    n = len(doc_idx)
    V, K, G = vocab_size, n_clusters, cluster_size
    lens = np.fromiter(map(len, doc_idx), np.int64, count=n)
    all_terms = np.concatenate(doc_idx).astype(np.int64)
    all_vals = np.ascontiguousarray(np.concatenate(doc_val), np.float32)
    all_cluster = np.repeat(cluster_of.astype(np.int64), lens)
    # segment-max via one sort: order postings by (term, cluster, value
    # desc) and keep each (term, cluster) run's first element
    flat = all_terms * K + all_cluster
    # np.empty + a sequential fill maps the (multi-GB) buffer's pages in
    # order before the scattered max-writes land in it
    summary = np.empty(V * K, np.float32)
    summary.fill(0)
    if V * K < (1 << 32):
        # the key IS the record: id in the high 32 bits, the complemented
        # f32 value bits (impacts are non-negative, so float bits compare
        # monotonically) in the low 32; one in-place sort, then the exact
        # f32 maxima straight from each run's first key
        key = flat.astype(np.uint64) << np.uint64(32)
        key |= (np.uint32(0xFFFFFFFF)
                - all_vals.view(np.uint32)).astype(np.uint64)
        key.sort()
        flat_s = (key >> np.uint64(32)).astype(np.int64)
        first = np.r_[True, flat_s[1:] != flat_s[:-1]]
        maxbits = (np.uint32(0xFFFFFFFF)
                   - (key[first] & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        summary[flat_s[first]] = maxbits.view(np.float32)
    else:
        order = np.lexsort((-all_vals, flat))
        flat_s = flat[order]
        first = np.r_[True, flat_s[1:] != flat_s[:-1]]
        summary[flat_s[first]] = all_vals[order][first]
    summary = summary.reshape(V, K)

    cluster_docs = np.full((K, G), pad_doc, np.int32)
    order = np.argsort(cluster_of, kind="stable")
    slot = np.arange(n) - np.searchsorted(cluster_of[order],
                                          cluster_of[order])
    cluster_docs[cluster_of[order], slot] = order
    return summary, cluster_docs


def summary_scores(q, summary):
    """[B, V] bf16 queries x [V, K] bf16 summaries -> [B, K] f32 scores, as
    the reference's ``jnp.dot(..., preferred_element_type=f32)``: products
    of bf16 operands summed in f32, never rounded to bf16. On the card one
    cuBLAS GEMM with an f32 output; on the CPU, which has no such GEMM, the
    operands widened to f32 (the products are exact there too)."""
    if q.is_cuda:
        return torch.mm(q, summary, out_dtype=torch.float32)
    return torch.matmul(q.float(), summary.float())


def union_candidates(summary, cluster_docs, post, q_idx, q_val,
                     vocab_size: int, n_probes: int, n_docs: int,
                     posting_candidates: int,
                     posting_scoring: str = "sort"):
    """Phases 1a and 1b: (the dense query [B, V+1] f32, the union's
    candidate ids [B, L*G (+ C_p)] int64, with duplicates and the pad doc
    id n_docs where a probed cluster has fewer than G members)."""
    B = q_idx.shape[0]
    qd = sparse_query_dense(q_idx, q_val, vocab_size)        # [B, V+1] f32
    s = summary_scores(qd[:, :vocab_size].to(torch.bfloat16), summary)
    L = min(n_probes, s.shape[1])
    cl = torch.topk(s, L, dim=1).indices
    cand = cluster_docs[cl].reshape(B, -1).long()            # [B, L*G]
    if post is not None:
        # sort-mode fillers carry doc id 0: they nominate doc 0, which the
        # exact rescore scores and the dedup keeps once
        _, cand_p = postings_score_topk(
            post[0], post[1], post[2], q_idx, q_val,
            min(posting_candidates, post[1].shape[1] * q_idx.shape[1]),
            n_docs, approx=False, scoring=posting_scoring)
        cand = torch.cat([cand, cand_p.long()], dim=1)
    return qd, cand


def dedup_topk(cand, scores, k: int):
    """Top-k of a candidate union that holds duplicates: sort by id, give
    every id equal to its left neighbour's -inf (a duplicate has the same
    exact score; the first copy stays), top-k. -inf slots come back as
    score 0 and id 0, which the caller's ``v > 0`` filter drops."""
    ids_s, perm = torch.sort(cand, dim=1, stable=True)
    sc_s = scores.gather(1, perm)
    dup = torch.cat([torch.zeros_like(ids_s[:, :1], dtype=torch.bool),
                     ids_s[:, 1:] == ids_s[:, :-1]], dim=1)
    sc_s = sc_s.masked_fill(dup, _NEG_INF)
    vals, pos = torch.topk(sc_s, min(k, sc_s.shape[1]), dim=1)
    out = ids_s.gather(1, pos)
    real = vals > _NEG_INF
    return (torch.where(real, vals, torch.zeros_like(vals)),
            torch.where(real, out, torch.zeros_like(out)))


def cluster_search_topk(summary, cluster_docs, post, d_terms, d_vals,
                        d_scale, q_idx, q_val, k: int, vocab_size: int,
                        n_probes: int, n_docs: int, posting_candidates: int,
                        posting_scoring: str = "sort",
                        rescore: str = "auto"):
    """Union-candidate two-level search: the clusters' and the postings'
    candidates (``union_candidates``; ``post`` is (post_docs, post_w,
    p_scale) or None), ONE exact rescore of the union, the dedup
    (``dedup_topk``). Returns (scores, doc ids), width min(k, pool)."""
    qd, cand = union_candidates(summary, cluster_docs, post, q_idx, q_val,
                                vocab_size, n_probes, n_docs,
                                posting_candidates, posting_scoring)
    scores = dispatch_rescore(d_terms, d_vals, d_scale, q_idx, q_val, cand,
                              vocab_size, mode=rescore, qd=qd)
    return dedup_topk(cand, scores, k)


def _resolve_posting_scoring(posting_scoring: str, query_top_t: int,
                             posting_cap: int) -> str:
    if posting_scoring not in ("auto", "sort", "scatter"):
        raise ValueError(f"posting_scoring: {posting_scoring!r} (the "
                         "union's postings side takes auto, sort or "
                         "scatter)")
    if posting_scoring == "auto":
        return "sort" if query_top_t * posting_cap <= 4096 else "scatter"
    if posting_scoring == "sort" and query_top_t * posting_cap > 4096:
        logger.warning(
            "query_top_t (%d) x posting_cap (%d) = %d > 4096 with "
            "posting_scoring='sort': the postings side sorts a [B, T*P] "
            "pool a query; 'scatter' (or 'auto') suits deep caps",
            query_top_t, posting_cap, query_top_t * posting_cap)
    return posting_scoring


class ClusterIndex(PostingsIndex):
    """Two-level cluster-summary index (see the module docstring).

    Counterpart of ``splade_tpu.ops.cluster_index.TpuClusterIndex``, with
    its API: add / add_csr / build / search_topk / search_vector / delete
    / update / compact / save / load / set_probes. ``cluster_size`` (G)
    and ``n_probes`` (L) size the cluster side; ``posting_cap`` (P) and
    ``posting_candidates`` (C_p) the postings side (posting_cap=0: clusters
    only). The candidate pool is L*G + C_p, held in
    ``rescore_candidates`` (the base class's max_results and tombstone
    guard read it). ``posting_scoring``: phase 1b's aggregation, "sort",
    "scatter" or "auto" (sort iff query_top_t * posting_cap <= 4096); the
    resolved mode is persisted."""

    _SAVE_KIND = "cluster"

    def __init__(self, vocab_size: int, cluster_size: int = 64,
                 n_probes: int = 32, query_top_t: int = 32,
                 batch_pad: int = 8, approx: bool = True,
                 posting_cap: int = 64, posting_candidates: int = 128,
                 posting_scoring: str = "auto", device: DeviceLike = None):
        super().__init__(
            vocab_size, query_top_t=query_top_t, batch_pad=batch_pad,
            approx=approx,
            rescore_candidates=n_probes * cluster_size + (
                posting_candidates if posting_cap else 0),
            device=device)
        self.posting_scoring = _resolve_posting_scoring(
            posting_scoring, query_top_t, posting_cap)
        self.cluster_size = cluster_size
        self.n_probes = n_probes
        self.posting_cap = posting_cap
        self.posting_candidates = posting_candidates
        self.n_clusters = 0
        self.build_seconds = 0.0

    def build(self) -> None:
        n = len(self.doc_ids)
        if n == 0:
            raise ValueError("empty index")
        t0 = time.perf_counter()
        cluster_of, K = assign_clusters(self._doc_idx, self._doc_val,
                                        self.cluster_size, self.vocab_size)
        self.n_clusters = K
        summary, cluster_docs = build_cluster_arrays(
            self._doc_idx, self._doc_val, cluster_of, K, self.cluster_size,
            self.vocab_size, pad_doc=n)
        # doc-major CSR for the exact rescore, plus ONE pad row (doc id n:
        # all pad terms, score exactly 0) so padded cluster slots rescore
        # to 0 and fall to the `v > 0` result filter
        terms, q, dscale = self._doc_major_arrays(
            self._doc_idx, self._doc_val, n)
        terms = np.concatenate(
            [terms, np.full((1, terms.shape[1]), self.vocab_size,
                            terms.dtype)])
        q = np.concatenate([q, np.zeros((1, q.shape[1]), np.int8)])
        dscale = np.concatenate([dscale, np.full((1,), 1e-6, np.float32)])
        dev = self.device
        built = [torch.from_numpy(summary).to(torch.bfloat16).to(dev),
                 torch.from_numpy(cluster_docs).to(dev)]
        if self.posting_cap:
            pd, pw, _ = invert_to_postings(
                self._doc_idx, self._doc_val, self.vocab_size,
                self.posting_cap)
            pq, pscale = quantize_postings(pw)
            built += [torch.from_numpy(a).to(dev) for a in (pd, pq, pscale)]
        self._built = tuple(built)
        # term ids widen to int32 on the device: the rescore kernel reads
        # int32 (see PostingsIndex._build_doc_major)
        self._doc_major = (torch.from_numpy(terms.astype(np.int32)).to(dev),
                           torch.from_numpy(q).to(dev),
                           torch.from_numpy(dscale).to(dev))
        self.truncated_postings = 0  # nothing is ever truncated
        self._base_n = n
        self._delta_cache = None
        self._make_search()
        self.build_seconds = time.perf_counter() - t0
        logger.info(
            "cluster index: %d docs in %d clusters (G=%d, probes=%d), "
            "%.0f MB on %s, built in %.1fs",
            n, K, self.cluster_size, self.n_probes,
            self.memory_bytes() / 1e6, dev, self.build_seconds)

    def _make_search(self) -> None:
        V = self.vocab_size
        L = self.n_probes
        C_p = self.posting_candidates
        n = len(self.doc_ids)
        scoring = self.posting_scoring
        with_post = bool(self.posting_cap)

        def search(q_idx, q_val, k):
            summary, cluster_docs, *post = self._built
            return cluster_search_topk(
                summary, cluster_docs, tuple(post) if with_post else None,
                *self._doc_major, q_idx, q_val, k, V, L, n, C_p,
                posting_scoring=scoring)

        self._search_fn = search

    def max_results(self) -> int:
        return min(len(self.doc_ids), self.rescore_candidates)

    def set_probes(self, n_probes: int) -> None:
        """Re-point the probe count without rebuilding: clustering,
        summaries and postings do not depend on it, only the search
        closure (and the candidate pool) do."""
        self.n_probes = n_probes
        self.rescore_candidates = n_probes * self.cluster_size + (
            self.posting_candidates if self.posting_cap else 0)
        if self._built is not None:
            self._delta_cache = None
            self._make_search()

    # --------------------------------------------------------- persistence
    def _config_array(self) -> np.ndarray:
        # field 7 persists the RESOLVED phase-1b mode (0 sort, 1 scatter):
        # a reload that re-resolved "auto" could serve another aggregation
        # than the one the saved index was validated with
        return np.asarray([self.vocab_size, self.cluster_size,
                           self.n_probes, self.query_top_t,
                           self.posting_cap, self.posting_candidates,
                           1 if self.posting_scoring == "scatter" else 0],
                          np.int64)

    @classmethod
    def _config_kwargs(cls, cfg: np.ndarray):
        vocab, G, L, top_t, P, C_p = (int(x) for x in cfg[:6])
        kw = dict(cluster_size=G, n_probes=L, query_top_t=top_t,
                  posting_cap=P, posting_candidates=C_p)
        if len(cfg) >= 7:  # archives from before the field resolve "auto"
            kw["posting_scoring"] = "scatter" if int(cfg[6]) else "sort"
        return vocab, kw

    def config_summary(self) -> str:
        return (f"cluster_size={self.cluster_size} "
                f"n_probes={self.n_probes} query_top_t={self.query_top_t} "
                f"posting_cap={self.posting_cap} "
                f"posting_candidates={self.posting_candidates} "
                f"posting_scoring={self.posting_scoring}")


class MeshShardedClusterIndex(DocSharded, ClusterIndex):
    """Doc-sharded cluster-summary index over a ``DeviceMesh``: shard d
    holds its documents' clusters, summary block, postings side and
    doc-major block on ``mesh.devices[d]``; a search runs the union search
    on every shard and merges the exact partial top-ks.
    Counterpart of ``splade_tpu``'s class of the same name, with its
    traps:

    - a shard's K comes from the bisection (``2^ceil(log2(docs/G))``, not
      ``ceil(docs/G)``): the Ks are collected first, then every shard is
      padded to the widest with pad clusters, all pad document with a zero
      summary;
    - doc-major rows are padded to ``per`` (terms V, values 0, scale 1e-6),
      plus the pad row at local id ``per`` that pad slots point at;
    - a shard fetches ``min(rescore_candidates, per + 1)``;
    - the merge requires a positive score: a pad document's global id is the
      next shard's first real document.

    Probes are per shard, so the candidate pool is D x (L*G + C_p);
    ``n_clusters`` sums the shards' Ks. ``posting_scoring`` is the base
    class's (the reference's mesh class has only its auto rule), so a
    saved cluster archive loads onto a mesh."""

    def __init__(self, vocab_size: int, mesh, cluster_size: int = 64,
                 n_probes: int = 32, query_top_t: int = 32,
                 batch_pad: int = 8, approx: bool = True,
                 posting_cap: int = 64, posting_candidates: int = 128,
                 posting_scoring: str = "auto"):
        super().__init__(vocab_size, cluster_size=cluster_size,
                         n_probes=n_probes, query_top_t=query_top_t,
                         batch_pad=batch_pad, approx=approx,
                         posting_cap=posting_cap,
                         posting_candidates=posting_candidates,
                         posting_scoring=posting_scoring,
                         device=mesh.devices[0])
        self._set_mesh(mesh)

    def max_results(self) -> int:
        return min(len(self.doc_ids), self.n_shards * self.rescore_candidates)

    def build(self) -> None:
        n = len(self.doc_ids)
        if n == 0:
            raise ValueError("empty index")
        t0 = time.perf_counter()
        per, bounds = self._shard_bounds()
        V, G = self.vocab_size, self.cluster_size
        M = max((len(x) for x in self._doc_idx), default=1)
        staged = []
        for lo, hi in bounds:
            di, dv = self._doc_idx[lo:hi], self._doc_val[lo:hi]
            if lo < hi:
                cluster_of, K = assign_clusters(di, dv, G, V)
                summary, cluster_docs = build_cluster_arrays(
                    di, dv, cluster_of, K, G, V, pad_doc=per)
            else:  # empty tail shard
                summary = np.zeros((V, 1), np.float32)
                cluster_docs = np.full((1, G), per, np.int32)
            terms, q, dscale = self._doc_major_arrays(di, dv, hi - lo, M=M)
            # rows padded to per, + the pad row (local id per) that pad
            # cluster slots point at: pad terms, zero values, scale 1e-6
            pad = per + 1 - (hi - lo)
            terms = np.concatenate([terms, np.full((pad, M), V, terms.dtype)])
            q = np.concatenate([q, np.zeros((pad, M), np.int8)])
            dscale = np.concatenate([dscale,
                                     np.full((pad,), 1e-6, np.float32)])
            post = ()
            if self.posting_cap:
                pd, pw, _ = invert_to_postings(
                    di or [np.zeros(0, np.int32)],
                    dv or [np.zeros(0, np.float32)], V, self.posting_cap)
                post = (pd, *quantize_postings(pw))
            staged.append((summary, cluster_docs, post,
                           (terms.astype(np.int32), q, dscale)))
        shard_ks = [x[1].shape[0] for x in staged]
        k_max = max(shard_ks)
        built, doc_major = [], []
        for dev, (summary, cluster_docs, post, dm) in zip(self.mesh.devices,
                                                          staged):
            K = cluster_docs.shape[0]
            # bf16 on the device, as the reference stages it (f16's 65504
            # maximum would overflow large impact sums)
            summ = torch.zeros((V, k_max), dtype=torch.bfloat16)
            summ[:, :K] = torch.from_numpy(summary).to(torch.bfloat16)
            cdocs = np.full((k_max, G), per, np.int32)
            cdocs[:K] = cluster_docs
            built.append((summ.to(dev),) + self._place(dev, cdocs, *post))
            doc_major.append(self._place(dev, *dm))
        staged.clear()
        self._built = tuple(built)
        self._doc_major = tuple(doc_major)
        self.n_clusters = int(sum(shard_ks))
        self.truncated_postings = 0
        self._base_n = n
        self._delta_cache = None
        self._make_search()
        self.build_seconds = time.perf_counter() - t0
        logger.info(
            "mesh cluster index: %d docs over %d shards (%d/shard, K<=%d "
            "each), %.0f MB total, built in %.1fs", n, self.n_shards, per,
            k_max, self.memory_bytes() / 1e6, self.build_seconds)

    def _make_search(self) -> None:
        """``_search_fn(q_idx, q_val, k)`` -> (scores, global doc ids): the
        union search on every shard, then the merge that requires a positive
        score (the serving engine's mesh route calls it too)."""
        V, L, C_p = self.vocab_size, self.n_probes, self.posting_candidates
        per, n = self._shard_size, len(self.doc_ids)
        scoring = self.posting_scoring
        with_post = bool(self.posting_cap)
        k_fetch = min(self.rescore_candidates, per + 1)
        devices = self.mesh.devices

        def search(q_idx, q_val, k):
            k_local = min(k, k_fetch)

            def shard_search(summary, cluster_docs, *rest):
                *arrays, qi, qv = rest
                post = tuple(arrays[:3]) if with_post else None
                return cluster_search_topk(
                    summary, cluster_docs, post, *arrays[-3:], qi, qv,
                    k_local, V, L, per, C_p, posting_scoring=scoring)

            vals, idxs = search_shards(devices, self.shard_arrays(),
                                       shard_search, q_idx, q_val)
            return merge_sharded_topk(vals, idxs, k, per, n,
                                      require_positive=True)

        self._search_fn = search
