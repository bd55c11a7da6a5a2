"""Postings-list sparse index for large corpora.

Counterpart of ``splade_tpu/ops/postings_index.py``:

- **Build** (host, numpy or the native builder): per vocab term keep the
  ``n_postings`` highest-impact (doc, weight) pairs, int8 with a per-term
  scale, padded to rectangular [V, P] arrays.
- **Phase 1**: gather the posting rows of the query's top-T terms
  ([B, T, P]), weight them, aggregate per doc (``scatter`` into a [B, N]
  accumulator, ``sort`` + segment-sum, ``select`` entries, or
  ``select_sum``), then top-k.
- **Phase 2** (two-phase, ``rescore_candidates > 0``): the doc-major CSR
  block re-scores the candidates EXACTLY; on the card through the Hopper
  rescore kernel (ops/rescore_kernel.py).

Filler contract of phase 1: slots beyond the distinct-doc pool carry val
-inf and id 0, and two-phase never rescores them.

**Doc sharding** (``MeshShardedPostingsIndex``, on a ``DeviceMesh``):
shard d holds documents ``[d·per, (d+1)·per)`` on ``mesh.devices[d]`` with
local ids, its own truncation and doc-major block. A search copies the
query to each shard's device, searches the shards one after another, each
under ``on_shard_device`` (the kernel library launches on the thread's
current card), brings the [B, k_local] partial top-ks back to
``mesh.devices[0]`` and merges them (``merge_sharded_topk``). The JAX
package does the same in one process: a ``vmap`` over the stacked shard
axis, placed by ``NamedSharding``.

``torch.topk`` replaces both ``lax.top_k`` and ``lax.approx_max_k``: the
``approx`` flag is kept for the API, and every top-k here is exact. Ties
may come out in another order than JAX's lower-index-first.
"""

from __future__ import annotations

import contextlib
import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from splade_tpu_torch.ops.rescore_kernel import rescore_match
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device
from splade_tpu_torch.utils.text import quantize_to_tier

logger = logging.getLogger(__name__)

_INT32_MAX = 2 ** 31 - 1
_NEG_INF = float("-inf")


# ------------------------------------------------------------------ build
def flatten_csr(doc_idx: Sequence[np.ndarray], doc_val: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-doc CSR lists -> flat (terms, vals, doc_of) posting triples."""
    n = len(doc_idx)
    all_terms = np.concatenate(doc_idx)
    all_vals = np.ascontiguousarray(np.concatenate(doc_val), np.float32)
    lens = np.fromiter(map(len, doc_idx), np.int64, count=n)
    all_docs = np.repeat(np.arange(n, dtype=np.int32), lens)
    return all_terms, all_vals, all_docs


def invert_flat(
    all_terms: np.ndarray, all_vals: np.ndarray, all_docs: np.ndarray,
    vocab_size: int, n_postings: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flat posting triples -> impact-ordered truncated postings
    (post_docs [V, P] int32, post_w [V, P] f32, n_truncated)."""
    V, P = vocab_size, n_postings
    if V >= (1 << 16) or len(all_vals) >= (1 << 32):
        raise ValueError("the packed uint64 key needs vocab < 65536 and "
                         "fewer than 2^32 postings")
    from splade_tpu_torch.ops.postings_native import build_postings_native

    native = build_postings_native(all_terms, all_vals, all_docs, V, P)
    if native is not None:
        return native
    # one uint64 per posting: term (16 bits) | complemented f16 impact (16)
    # | position (32); one in-place sort orders by (term asc, impact desc)
    key = all_terms.astype(np.uint64)
    key <<= np.uint64(48)
    key |= (np.uint16(0xFFFF) -
            all_vals.astype(np.float16).view(np.uint16)
            ).astype(np.uint64) << np.uint64(32)
    key |= np.arange(len(key), dtype=np.uint64)
    key.sort()
    bounds = np.arange(V + 1, dtype=np.uint64) << np.uint64(48)
    starts = np.searchsorted(key, bounds[:-1])
    ends = np.searchsorted(key, bounds[1:])
    df = (ends - starts).astype(np.int64)
    kept = np.minimum(df, P)
    post_docs = np.zeros((V, P), np.int32)   # pad doc 0 w/ weight 0
    post_w = np.zeros((V, P), np.float32)
    rows = np.repeat(np.arange(V, dtype=np.int64), kept)
    offs = (np.arange(len(rows)) -
            np.repeat(np.cumsum(kept) - kept, kept))
    src = (key[np.repeat(starts, kept) + offs]
           & np.uint64(0xFFFFFFFF)).astype(np.int64)
    post_docs[rows, offs] = all_docs[src]
    post_w[rows, offs] = all_vals[src]
    return post_docs, post_w, int((df - kept).sum())


def invert_to_postings(
    doc_idx: Sequence[np.ndarray], doc_val: Sequence[np.ndarray],
    vocab_size: int, n_postings: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """CSR docs -> impact-ordered truncated postings (see invert_flat).
    Impact order within a term is float16-approximate; stored values are
    the exact float32 ones."""
    all_terms, all_vals, all_docs = flatten_csr(doc_idx, doc_val)
    return invert_flat(all_terms, all_vals, all_docs, vocab_size, n_postings)


def quantize_postings(post_w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-term int8 quantization against each term's true max impact.
    Returns (q [V, P] int8, scale [V] f32)."""
    scale = np.maximum(post_w.max(axis=1), 1e-6) / 127.0
    q = np.clip(np.round(post_w / scale[:, None]), 0, 127).astype(np.int8)
    return q, scale.astype(np.float32)


# ---------------------------------------------------------------- phase 1
def _segment_sums(sid: torch.Tensor, sval: torch.Tensor):
    """Per-row runs of equal ids in sorted ``sid``: (run totals at each
    slot's run, is_end [B, E] marking each run's last slot)."""
    B = sid.shape[0]
    edge = sid[:, 1:] != sid[:, :-1]
    one = torch.ones((B, 1), dtype=torch.bool, device=sid.device)
    start = torch.cat([one, edge], dim=1)
    run = torch.cumsum(start.to(torch.int64), dim=1) - 1
    totals = torch.zeros_like(sval).scatter_add_(1, run, sval)
    return totals.gather(1, run), torch.cat([edge, one], dim=1)


def _sorted_segment_topk(rows_d, contrib, k: int):
    """Corpus-size-independent aggregation: sort the query's E = T*P
    gathered (doc id, contribution) pairs by id, sum runs of equal ids,
    top-k. Returns (scores [B, k'], doc_ids [B, k']); slots beyond the
    distinct-doc count are fillers (val -inf, id 0)."""
    B = rows_d.shape[0]
    ids = rows_d.reshape(B, -1)
    c = contrib.reshape(B, -1).to(torch.float32)
    sid, perm = torch.sort(ids, dim=1, stable=True)
    seg, is_end = _segment_sums(sid, c.gather(1, perm))
    scores = torch.where(is_end, seg, torch.full_like(seg, _NEG_INF))
    vals, pos = torch.topk(scores, min(k, ids.shape[1]), dim=1)
    out_ids = sid.gather(1, pos)
    return vals, torch.where(vals > _NEG_INF, out_ids,
                             torch.zeros_like(out_ids))


def _select_topk_candidates(rows_d, contrib, k: int, approx: bool):
    """Phase-1 CANDIDATE SELECTION without per-doc aggregation: the top-k
    posting entries by single-posting contribution, deduplicated by id.
    Duplicate and non-positive slots are fillers (val -inf, id 0)."""
    B = rows_d.shape[0]
    ids = rows_d.reshape(B, -1)
    c = contrib.reshape(B, -1).to(torch.float32)
    vals, pos = torch.topk(c, min(k, ids.shape[1]), dim=1)
    cand = ids.gather(1, pos)
    sid, perm = torch.sort(cand, dim=1, stable=True)
    sval = vals.gather(1, perm)
    first = torch.cat([torch.ones((B, 1), dtype=torch.bool,
                                  device=sid.device),
                       sid[:, 1:] != sid[:, :-1]], dim=1)
    # contribution <= 0: a pad query slot or padded posting, never real
    keep = first & (sval > 0)
    return (torch.where(keep, sval, torch.full_like(sval, _NEG_INF)),
            torch.where(keep, sid, torch.zeros_like(sid)))


def _select_sum_topk(rows_d, contrib, k: int, approx: bool,
                     pool_mult: int = 4):
    """Phase-1 CANDIDATE SELECTION by partial sums over the top
    ``pool_mult * k`` entries: sort that pool by id, sum runs, rank docs by
    their pooled evidence. Same filler contract as the other modes."""
    B = rows_d.shape[0]
    ids = rows_d.reshape(B, -1)
    c = contrib.reshape(B, -1).to(torch.float32)
    kp = min(pool_mult * k, ids.shape[1])
    vals, pos = torch.topk(c, kp, dim=1)
    cand = ids.gather(1, pos)
    # pads / non-positive contributions go to a sentinel id that sorts last
    valid = vals > 0
    cand = torch.where(valid, cand, torch.full_like(cand, _INT32_MAX))
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    sid, perm = torch.sort(cand, dim=1, stable=True)
    seg, is_end = _segment_sums(sid, vals.gather(1, perm))
    totals = torch.where(is_end & (sid != _INT32_MAX), seg,
                         torch.full_like(seg, _NEG_INF))
    out_vals, pos2 = torch.topk(totals, min(k, kp), dim=1)
    out_ids = sid.gather(1, pos2)
    return out_vals, torch.where(out_vals > _NEG_INF, out_ids,
                                 torch.zeros_like(out_ids))


def postings_score_topk(post_docs, post_w, scale, q_idx, q_val, k: int,
                        n_docs: int, approx: bool, acc_dtype=None,
                        scoring: str = "scatter"):
    """The one postings scoring function: gather the query terms' rows,
    int8-dequantized contributions, aggregate per doc, top-k. Returns
    (scores [B, k], doc ids [B, k] int64).

    ``scoring``: "scatter" adds into a [B, n_docs] accumulator of
    ``acc_dtype`` (f32 default; bf16 for the candidate phase of two-phase,
    where scores only rank). On CUDA, ``scatter_add_`` is atomic and its
    order unordered, so bf16 sums may differ from run to run in the last
    bits: acceptable, because phase 1 only selects candidates and phase 2
    re-scores them exactly. "sort", "select" and "select_sum" as in the
    helpers above; "select*" are phase-1-of-two-phase only."""
    if acc_dtype is None:
        acc_dtype = torch.float32
    qi = q_idx.long()
    rows_d = post_docs[qi].long()                   # [B, T, P] gather
    qw = q_val.to(torch.float32) * scale[qi]        # [B, T]
    if scoring in ("sort", "select", "select_sum"):
        contrib = post_w[qi].to(torch.float32) * qw[:, :, None]
        if scoring == "select":
            return _select_topk_candidates(rows_d, contrib, k, approx)
        if scoring == "select_sum":
            return _select_sum_topk(rows_d, contrib, k, approx)
        return _sorted_segment_topk(rows_d, contrib, k)
    contrib = (post_w[qi].to(torch.bfloat16)
               * qw[:, :, None].to(torch.bfloat16))
    B = qi.shape[0]
    acc = torch.zeros((B, n_docs), dtype=acc_dtype, device=rows_d.device)
    acc.scatter_add_(1, rows_d.reshape(B, -1),
                     contrib.reshape(B, -1).to(acc_dtype))
    return torch.topk(acc, k, dim=1)


# ---------------------------------------------------------------- phase 2
def sparse_query_dense(q_idx, q_val, vocab_size: int):
    """[B, T] sparse query -> [B, V+1] dense (column V: pad terms -> 0)."""
    B = q_idx.shape[0]
    qd = torch.zeros((B, vocab_size + 1), dtype=torch.float32,
                     device=q_idx.device)
    return qd.scatter_add_(1, q_idx.long(), q_val.to(torch.float32))


def exact_rescore(d_terms, d_vals, d_scale, qd, cand):
    """EXACT f32 scores of candidate docs from the doc-major CSR block:
    d_terms [N, M] (pad id V -> zero column of qd), d_vals [N, M] int8 with
    per-doc d_scale [N]; qd [B, V+1]; cand [B, C]. The plain phase 2."""
    B, C = cand.shape
    cand = cand.long()
    terms = d_terms[cand].long()                                 # [B, C, M]
    w = d_vals[cand].to(torch.float32) * d_scale[cand][:, :, None]
    qv = qd.gather(1, terms.reshape(B, -1)).reshape(terms.shape)
    return (qv * w).sum(-1)


RESCORE_MODES = ("gather", "match")


def resolve_rescore_mode(mode: str = "auto",
                         device: Optional[torch.device] = None) -> str:
    """Pick the phase-2 rescore implementation.

    "match": the Hopper rescore kernel (ops/rescore_kernel.py; its plain
    version on a CPU tensor). "gather": ``exact_rescore``'s dense-query
    gather, the CPU default. "auto" resolves to "match" on CUDA and
    "gather" on the CPU. Env SPLADE_RESCORE overrides everything (A/B
    switch)."""
    env = os.environ.get("SPLADE_RESCORE", "").lower()
    if env in RESCORE_MODES:
        mode = env
    if mode == "auto":
        return ("match" if device is not None and device.type == "cuda"
                else "gather")
    if mode not in RESCORE_MODES:
        raise ValueError(f"rescore mode {mode!r} not in {RESCORE_MODES}")
    return mode


def dispatch_rescore(d_terms, d_vals, d_scale, q_idx, q_val, cand,
                     vocab_size: int, mode: str = "auto", qd=None):
    """The one phase-2 entry point: exact f32 candidate scores via the mode
    resolve_rescore_mode picks. All modes agree within 1e-4."""
    mode = resolve_rescore_mode(mode, cand.device)
    if mode == "gather":
        if qd is None:
            qd = sparse_query_dense(q_idx, q_val, vocab_size)
        return exact_rescore(d_terms, d_vals, d_scale, qd, cand)
    return rescore_match(d_terms, d_vals, d_scale, q_idx, q_val, cand)


def postings_two_phase_topk(post_docs, post_w, scale, d_terms, d_vals,
                            d_scale, q_idx, q_val, k: int, n_docs: int,
                            vocab_size: int, n_candidates: int, approx: bool,
                            phase1_dtype=None, scoring: str = "scatter",
                            rescore: str = "auto"):
    """Two-phase search: short-cap postings rank ``n_candidates``, then
    the doc-major CSR re-scores them exactly. Phase-1 scores only pick
    candidates, so its [B, N] accumulator defaults to bf16."""
    if phase1_dtype is None:
        phase1_dtype = torch.bfloat16
    p1_vals, cand = postings_score_topk(post_docs, post_w, scale, q_idx,
                                        q_val, n_candidates, n_docs, approx,
                                        acc_dtype=phase1_dtype,
                                        scoring=scoring)           # [B, C]
    scores = dispatch_rescore(d_terms, d_vals, d_scale, q_idx, q_val, cand,
                              vocab_size, mode=rescore)
    # filler slots (val -inf, id 0) must not resurface as doc 0
    scores = torch.where(p1_vals == _NEG_INF,
                         torch.full_like(scores, _NEG_INF), scores)
    vals, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return vals, cand.gather(1, pos)


# ------------------------------------------------------------------ mesh
def on_shard_device(device: torch.device):
    """The context one shard's search runs in: on a CUDA device, that card
    made the thread's current device (the kernel library launches on the
    current device, ``ops/_cuda.py``); elsewhere nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def search_shards(devices, shards, shard_search, q_idx, q_val):
    """``shard_search(*shards[d], q_idx, q_val)`` for every shard, one after
    another, under ``on_shard_device(devices[d])`` with the query copied to
    that device. The [B, k_local] partials come back to ``devices[0]``,
    stacked into [D, B, k_local] (every shard returns the same width)."""
    home = devices[0]
    vals, idxs = [], []
    for dev, arrays in zip(devices, shards):
        with on_shard_device(dev):
            v, i = shard_search(*arrays, q_idx.to(dev), q_val.to(dev))
        vals.append(v.to(home))
        idxs.append(i.to(home))
    return torch.stack(vals), torch.stack(idxs)


def merge_sharded_topk(vals, idxs, k: int, shard_size: int, n_docs: int,
                       require_positive: bool = False):
    """Merge [D, B, k_local] per-shard partial top-ks into a global
    [B, min(k, D*k_local)]: local -> global doc ids (+ d·shard_size), one
    top-k over the D·k_local slots, then ids >= n_docs (a ragged or empty
    tail shard's pad documents) masked to (0.0, 0). The one owner of the
    cross-shard merge, shared by the three doc-sharded indexes.

    ``require_positive`` also masks scores <= 0: the cluster index's pad
    document lives at local id ``shard_size``, whose global id is the next
    shard's first real document, so only its zero score can filter it."""
    D, B, k_local = vals.shape
    offset = torch.arange(D, dtype=torch.int64, device=idxs.device)
    idxs = idxs.long() + (offset * shard_size)[:, None, None]
    vals = vals.permute(1, 0, 2).reshape(B, D * k_local)
    idxs = idxs.permute(1, 0, 2).reshape(B, D * k_local)
    mvals, mpos = torch.topk(vals, min(k, D * k_local), dim=1)
    mids = idxs.gather(1, mpos)
    valid = mids < n_docs
    if require_positive:
        valid = valid & (mvals > 0)
    return (torch.where(valid, mvals, torch.zeros_like(mvals)),
            torch.where(valid, mids, torch.zeros_like(mids)))


def make_mesh_postings_search_fns(mesh, shard_size: int, n_docs: int,
                                  vocab_size: int, n_candidates: int,
                                  approx: bool, acc_dtype, scoring: str):
    """Search bodies of doc-sharded postings, shared by
    ``MeshShardedPostingsIndex`` and the serving engine's mesh route:
    ``(search, search_two_phase)``, each ``(shards, q_idx, q_val, k)`` ->
    (scores, global doc ids), ``shards`` the per-shard array tuples in
    ``mesh.devices`` order (phase 1, then the doc-major block). A shard
    returns at most ``min(k, per)`` documents, and ``min(k, per, C)`` when
    two-phase; each rescores its candidates exactly, so the merged scores
    are exact."""
    per, n, V, C = shard_size, n_docs, vocab_size, n_candidates

    def search(shards, q_idx, q_val, k):
        k_local = min(k, per)

        def shard_search(pd, pw, sc, qi, qv):
            return postings_score_topk(pd, pw, sc, qi, qv, k_local, per,
                                       approx, acc_dtype=acc_dtype,
                                       scoring=scoring)

        vals, idxs = search_shards(mesh.devices, shards, shard_search,
                                   q_idx, q_val)
        # sort scoring caps a shard's output at its T*P pool, which can be
        # below k_local: the merge takes the width actually returned
        return merge_sharded_topk(vals, idxs, k, per, n)

    def search_two_phase(shards, q_idx, q_val, k):
        k_local = min(k, per, C)

        def shard_search(pd, pw, sc, dt, dv, ds, qi, qv):
            return postings_two_phase_topk(
                pd, pw, sc, dt, dv, ds, qi, qv, k_local, per, V, C, approx,
                phase1_dtype=acc_dtype, scoring=scoring)

        vals, idxs = search_shards(mesh.devices, shards, shard_search,
                                   q_idx, q_val)
        return merge_sharded_topk(vals, idxs, k, per, n)

    return search, search_two_phase


def _tensors(tree):
    """The tensors of nested tuples (a mesh index keeps one tuple a shard)."""
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif tree is not None:
        yield tree


# ------------------------------------------------------------------ index
class PostingsIndex:
    """Impact-ordered truncated postings on the device.

    Counterpart of ``splade_tpu.ops.postings_index.TpuPostingsIndex``:
    add / add_batch / add_csr / build, the LSM delta segment (documents
    added after build() are scored exactly on the host and merged),
    tombstone deletes, compact, search_topk, search_vector and save/load
    in the same npz format (a ``splade_tpu`` archive loads here).
    """

    def __init__(
        self,
        vocab_size: int,
        n_postings: int = 2048,
        query_top_t: int = 32,
        batch_pad: int = 8,
        approx: bool = True,
        rescore_candidates: int = 0,
        phase1_acc: str = "auto",
        scoring: str = "auto",
        device: DeviceLike = None,
    ):
        """rescore_candidates > 0 enables two-phase search (pair it with a
        short cap, n_postings ~64-256). phase1_acc: "f32" | "bf16" | "auto"
        (bf16 when two-phase) — dtype of the scatter accumulator. scoring:
        "scatter" | "sort" | "select" | "select_sum" | "auto"
        (see resolved_scoring); "select*" need rescore_candidates > 0."""
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.n_postings = n_postings
        self.query_top_t = query_top_t
        self.batch_pad = batch_pad
        self.approx = approx
        self.rescore_candidates = rescore_candidates
        if phase1_acc not in ("auto", "f32", "bf16"):
            raise ValueError(f"phase1_acc: {phase1_acc!r}")
        self.phase1_acc = phase1_acc
        if scoring not in ("auto", "scatter", "sort", "select",
                           "select_sum"):
            raise ValueError(f"scoring: {scoring!r}")
        if scoring in ("select", "select_sum") and not rescore_candidates:
            raise ValueError(
                f"scoring={scoring!r} returns candidate-selection scores, "
                "not per-doc totals — it requires the two-phase exact "
                "rescore (rescore_candidates > 0)")
        self.scoring = scoring
        self.doc_ids: List[str] = []
        self.nnz = 0
        self._doc_idx: List[np.ndarray] = []
        self._doc_val: List[np.ndarray] = []
        self._built = None      # (post_docs [V,P] i32, post_w [V,P] i8, scale [V])
        self._doc_major = None  # (terms [N,M] i32, vals [N,M] i8, scale [N])
        self._search_fn = None
        self.truncated_postings = 0
        self._base_n = 0        # docs covered by _built; the rest: the delta
        self._delta_cache = None
        self._tombstones: set = set()
        self._id_pos: Optional[Dict[str, int]] = None

    #: top-k width tiers of the base search (see search_topk)
    _K_TIERS = (10, 20, 50, 100, 200, 500, 1000)

    # ---------------------------------------------------------------- build
    def add(self, doc_id: str, indices: np.ndarray, values: np.ndarray) -> None:
        self.doc_ids.append(doc_id)
        idx = np.asarray(indices, np.int32)
        self._doc_idx.append(idx)
        self._doc_val.append(np.asarray(values, np.float32))
        self.nnz += len(idx)
        if self._id_pos is not None:
            self._id_pos[doc_id] = len(self.doc_ids) - 1
        self._delta_cache = None

    def add_batch(self, doc_ids: Sequence[str],
                  vecs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        for did, (idx, val) in zip(doc_ids, vecs):
            self.add(did, idx, val)

    def add_csr(self, doc_ids: Sequence[str], indices: np.ndarray,
                values: np.ndarray) -> None:
        """Bulk staging of [N, nnz] rectangular term-id/weight blocks."""
        if not len(doc_ids) == len(indices) == len(values):
            raise ValueError("doc_ids, indices and values differ in length")
        start = len(self.doc_ids)
        self.doc_ids.extend(doc_ids)
        self._doc_idx.extend(np.asarray(indices, np.int32))
        self._doc_val.extend(np.asarray(values, np.float32))
        self.nnz += int(np.prod(np.asarray(indices).shape))
        if self._id_pos is not None:
            for i, d in enumerate(doc_ids):
                self._id_pos[d] = start + i
        self._delta_cache = None

    @property
    def delta_count(self) -> int:
        if self._built is None:
            return 0
        return len(self.doc_ids) - self._base_n

    # -------------------------------------------------------- delete/update
    def _positions(self) -> Dict[str, int]:
        """doc_id -> position (last wins), built once, then kept
        incrementally by add()/add_csr()."""
        if self._id_pos is None:
            self._id_pos = {d: i for i, d in enumerate(self.doc_ids)}
        return self._id_pos

    def delete(self, doc_ids: Sequence[str]) -> int:
        """Tombstone documents: they leave results at once; compact()
        reclaims them. Returns the number actually deleted."""
        pos = self._positions()
        hit = [pos[d] for d in doc_ids
               if d in pos and pos[d] not in self._tombstones]
        self._tombstones.update(hit)
        return len(hit)

    def update(self, doc_id: str, indices: np.ndarray,
               values: np.ndarray) -> None:
        self.delete([doc_id])
        self.add(doc_id, indices, values)

    @property
    def deleted_count(self) -> int:
        return len(self._tombstones)

    def compact(self) -> None:
        """Fold the delta into the main structure and drop tombstoned
        documents. Compacting away every document leaves an empty index."""
        if self._tombstones:
            keep = [i for i in range(len(self.doc_ids))
                    if i not in self._tombstones]
            self.doc_ids = [self.doc_ids[i] for i in keep]
            self._doc_idx = [self._doc_idx[i] for i in keep]
            self._doc_val = [self._doc_val[i] for i in keep]
            self.nnz = int(sum(len(x) for x in self._doc_idx))
            self._tombstones = set()
            self._id_pos = None
        if not self.doc_ids:
            self._built = None
            self._doc_major = None
            self._base_n = 0
            self._delta_cache = None
            self._search_fn = None
            return
        self.build()

    def score_delta(self, q_indices, q_values) -> np.ndarray:
        """Exact f32 scores of the delta docs, [B, delta_count], on the
        host (the delta is small by policy; compact() when it grows)."""
        B = len(q_indices)
        D = self.delta_count
        if D == 0:
            return np.zeros((B, 0), np.float32)
        if self._delta_cache is None:
            terms, q, dscale = self._doc_major_arrays(
                self._doc_idx[self._base_n:], self._doc_val[self._base_n:], D)
            self._delta_cache = (terms.astype(np.int64),
                                 q.astype(np.float32) * dscale[:, None])
        terms, vals = self._delta_cache
        qd = np.zeros((B, self.vocab_size + 1), np.float32)
        for b in range(B):
            np.add.at(qd[b], np.asarray(q_indices[b], np.int64),
                      np.asarray(q_values[b], np.float32))
        return np.einsum("bdm,dm->bd", qd[:, terms], vals, optimize=True)

    def merge_delta(self, out: List[List[Tuple[str, float]]],
                    d_scores: np.ndarray, k: int
                    ) -> List[List[Tuple[str, float]]]:
        """Merge delta scores ([B, delta_count]) into per-query result
        lists: the one place delta/tombstone merge semantics live."""
        base_n = self._base_n
        d_ids = self.doc_ids[base_n:]
        tomb = self._tombstones
        for b in range(len(out)):
            extra = [(d_ids[j], float(s))
                     for j, s in enumerate(d_scores[b])
                     if s > 0 and (base_n + j) not in tomb]
            if extra:
                out[b] = sorted(out[b] + extra, key=lambda t: -t[1])[:k]
        return out

    def build(self) -> None:
        n = len(self.doc_ids)
        if n == 0:
            raise ValueError("empty index")
        post_docs, post_w, self.truncated_postings = invert_to_postings(
            self._doc_idx, self._doc_val, self.vocab_size, self.n_postings)
        q, scale = quantize_postings(post_w)
        dev = self.device
        self._built = tuple(torch.from_numpy(a).to(dev)
                            for a in (post_docs, q, scale))
        if self.rescore_candidates:
            self._doc_major = self._build_doc_major()
        self._base_n = n
        self._delta_cache = None
        self._make_search()
        logger.info(
            "postings index: %d docs, cap P=%d (truncated %.2f%% of "
            "postings), %.0f MB on %s",
            n, self.n_postings,
            100.0 * self.truncated_postings / max(self.nnz, 1),
            self.memory_bytes() / 1e6, dev)

    def _doc_major_arrays(self, doc_idx, doc_val, n_rows: int, M: int = 0):
        """Host doc-major CSR block: [n_rows, M] term ids (pad id = V, a
        zero column of the query lookup), int8 weights, per-doc scales.
        Host term ids are uint16 when the vocab fits."""
        lens = [len(x) for x in doc_idx]
        M = max(M, max(lens, default=1))
        tdtype = np.uint16 if self.vocab_size < 2 ** 16 else np.int32
        if len(doc_idx) == n_rows and lens and min(lens) == M:
            terms = np.stack(doc_idx).astype(tdtype)
            vals = np.stack(doc_val).astype(np.float32)
        else:
            terms = np.full((n_rows, M), self.vocab_size, tdtype)
            vals = np.zeros((n_rows, M), np.float32)
            for i, (ti, tv) in enumerate(zip(doc_idx, doc_val)):
                terms[i, :len(ti)] = ti
                vals[i, :len(tv)] = tv
        dscale = np.maximum(np.abs(vals).max(axis=1), 1e-6) / 127.0
        q = np.clip(np.round(vals / dscale[:, None]), -127, 127).astype(np.int8)
        return terms, q, dscale.astype(np.float32)

    def _build_doc_major(self):
        """Device doc-major block. Term ids widen to int32 on the device:
        the rescore kernel reads int32 (torch's uint16 supports few ops)."""
        terms, q, dscale = self._doc_major_arrays(
            self._doc_idx, self._doc_val, len(self.doc_ids))
        dev = self.device
        return (torch.from_numpy(terms.astype(np.int32)).to(dev),
                torch.from_numpy(q).to(dev), torch.from_numpy(dscale).to(dev))

    def acc_dtype(self) -> torch.dtype:
        if self.phase1_acc == "bf16":
            return torch.bfloat16
        if self.phase1_acc == "f32":
            return torch.float32
        # two-phase scores only rank candidates; single-phase ones are final
        return torch.bfloat16 if self.rescore_candidates else torch.float32

    def resolved_scoring(self) -> str:
        """'auto' -> 'sort' when the gathered pool T*P is at most 4096
        (the reference's non-TPU bound), else 'scatter'."""
        if self.scoring != "auto":
            return self.scoring
        return ("sort" if self.query_top_t * self.n_postings <= 4096
                else "scatter")

    # ---------------------------------------------------------------- search
    def _make_search(self) -> None:
        n = len(self.doc_ids)
        V = self.vocab_size
        C = min(self.rescore_candidates, n) if self.rescore_candidates else 0
        acc_dtype = self.acc_dtype()
        scoring = self.resolved_scoring()
        approx = self.approx

        if C:
            def search(q_idx, q_val, k):
                return postings_two_phase_topk(
                    *self._built, *self._doc_major, q_idx, q_val, k, n, V, C,
                    approx, phase1_dtype=acc_dtype, scoring=scoring)
        else:
            def search(q_idx, q_val, k):
                return postings_score_topk(
                    *self._built, q_idx, q_val, k, n, approx,
                    acc_dtype=acc_dtype, scoring=scoring)
        self._search_fn = search

    def search_topk(
        self, q_indices: np.ndarray, q_values: np.ndarray, k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        """Batched sparse queries: [B, T] term ids + weights (pad with
        weight 0). T is truncated/padded to ``query_top_t``."""
        if not self.doc_ids:
            return [[] for _ in range(len(np.asarray(q_indices)))]
        if (self.rescore_candidates and self._tombstones
                and k + len(self._tombstones) > self.rescore_candidates):
            # two-phase clamps the fetch at the candidate pool: compact for
            # a hard k-results guarantee
            self.compact()
        if self._built is None:
            self.build()
        k = min(k, len(self.doc_ids))
        q_indices = np.asarray(q_indices, np.int32)
        q_values = np.asarray(q_values, np.float32)
        B, T = q_indices.shape
        Tt = self.query_top_t
        if T > Tt:  # keep the strongest T terms
            keep = np.argsort(-q_values, axis=1)[:, :Tt]
            q_indices = np.take_along_axis(q_indices, keep, axis=1)
            q_values = np.take_along_axis(q_values, keep, axis=1)
        elif T < Tt:
            q_indices = np.pad(q_indices, ((0, 0), (0, Tt - T)))
            q_values = np.pad(q_values, ((0, 0), (0, Tt - T)))
        pad_b = -B % self.batch_pad
        if pad_b:
            q_indices = np.pad(q_indices, ((0, pad_b), (0, 0)))
            q_values = np.pad(q_values, ((0, pad_b), (0, 0)))
        # over-fetch by the tombstone count so deletes don't shrink results
        # below k, quantized to a tier as the serving engine does
        k_base = quantize_to_tier(k + len(self._tombstones), self._K_TIERS,
                                  cap=self._base_n)
        with torch.no_grad():
            vals, idxs = self._search_fn(
                torch.from_numpy(q_indices).to(self.device),
                torch.from_numpy(q_values).to(self.device), k_base)
        vals = vals.float().cpu().numpy()[:B]
        idxs = idxs.cpu().numpy()[:B]
        tomb = self._tombstones
        out = [[(self.doc_ids[int(i)], float(v))
                for v, i in zip(vals[b], idxs[b])
                if v > 0 and int(i) not in tomb][:k]
               for b in range(B)]
        if self.delta_count:
            d_scores = self.score_delta(q_indices[:B], q_values[:B])
            out = self.merge_delta(out, d_scores, k)
        return out

    def search_vector(self, indices: np.ndarray, values: np.ndarray,
                      k: int = 10) -> List[Tuple[str, float]]:
        """One sparse query, (term ids, weights), through search_topk."""
        return self.search_topk(np.asarray(indices)[None],
                                np.asarray(values)[None], k)[0]

    # --------------------------------------------------------- persistence
    #: archive format discriminator (the reference's npz "kind" field)
    _SAVE_KIND = "postings"

    def _config_array(self) -> np.ndarray:
        return np.asarray([self.vocab_size, self.n_postings,
                           self.query_top_t, self.rescore_candidates],
                          np.int64)

    def config_summary(self) -> str:
        """Human-readable shape line for operator logs."""
        return (f"n_postings={self.n_postings} "
                f"query_top_t={self.query_top_t} "
                f"rescore={self.rescore_candidates}")

    @classmethod
    def _config_kwargs(cls, cfg: np.ndarray):
        vocab, P, top_t, C = (int(x) for x in cfg)
        return vocab, dict(n_postings=P, query_top_t=top_t,
                           rescore_candidates=C)

    def save(self, path: str) -> None:
        """Persist the staged corpus (CSR + ids + config); tombstones and
        the delta compact into the saved state."""
        if self._tombstones:
            self.compact()
        lens = np.fromiter((len(x) for x in self._doc_idx), np.int64,
                           count=len(self._doc_idx))
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(out.suffix + ".tmp")
        with open(tmp, "wb") as f:
            np.savez_compressed(
                f,
                # fixed-width unicode, not dtype=object: the archive loads
                # with allow_pickle=False
                doc_ids=np.asarray(self.doc_ids, dtype=np.str_),
                lens=lens,
                terms=np.concatenate(self._doc_idx) if len(lens) else
                np.zeros(0, np.int32),
                vals=np.concatenate(self._doc_val) if len(lens) else
                np.zeros(0, np.float32),
                config=self._config_array(),
                kind=np.asarray(self._SAVE_KIND),
            )
        os.replace(tmp, out)
        logger.info("saved index corpus (%d docs) -> %s",
                    len(self.doc_ids), path)

    @staticmethod
    def sniff_kind(z) -> str:
        """Archive kind of an open npz (archives from before the field
        infer it from the config width)."""
        if "kind" in z.files:
            return str(z["kind"])
        return {4: "postings", 6: "cluster", 7: "cluster"}.get(
            len(z["config"]), "?")

    @classmethod
    def load(cls, path: str, **overrides) -> "PostingsIndex":
        """Restore a saved corpus and build the device structures. Saved
        config (vocab/cap/top-T/rescore) applies unless overridden;
        ``device`` goes in ``overrides``."""
        try:
            z_ctx = np.load(path, allow_pickle=False)
        except ValueError as e:
            if "pickle" in str(e).lower():
                raise ValueError(
                    f"{path} is a legacy index cache (pickled doc_ids); "
                    "rebuild it once and save() again") from e
            raise
        with z_ctx as z:
            kind = cls.sniff_kind(z)
            if kind != cls._SAVE_KIND:
                raise ValueError(
                    f"{path} is a {kind!r} index cache but "
                    f"{cls.__name__}.load expects {cls._SAVE_KIND!r}")
            vocab, kw = cls._config_kwargs(z["config"])
            kw.update(overrides)
            index = cls(vocab, **kw)
            lens = z["lens"]
            bounds = np.cumsum(lens)[:-1]
            index.add_batch(
                [str(d) for d in z["doc_ids"]],
                list(zip(np.split(z["terms"], bounds),
                         np.split(z["vals"], bounds))))
        index.build()
        return index

    # ---------------------------------------------------------------- info
    def max_results(self) -> int:
        """Largest k a search can honor (two-phase: the candidate pool)."""
        n = len(self.doc_ids)
        return min(n, self.rescore_candidates) if self.rescore_candidates else n

    def __len__(self) -> int:
        return len(self.doc_ids)

    def memory_bytes(self) -> int:
        if self._built is None:
            return 0
        return sum(a.numel() * a.element_size()
                   for a in _tensors((self._built, self._doc_major)))


class DocSharded:
    """What the doc-sharded indexes share: the mesh, contiguous shards of
    ``per = ceil(n / D)`` documents (a tail shard may be short or empty),
    ``_built`` and ``_doc_major`` kept as one tuple of tensors a shard, on
    that shard's device, and the largest k a two-phase search honours."""

    def _set_mesh(self, mesh) -> None:
        self.mesh = mesh
        self.n_shards = mesh.size
        self._shard_size = 0  # per, set at build

    def _shard_bounds(self):
        """(per, [(lo, hi)] a shard) of the staged documents."""
        n = len(self.doc_ids)
        per = -(-n // self.n_shards)
        self._shard_size = per
        return per, [(min(d * per, n), min((d + 1) * per, n))
                     for d in range(self.n_shards)]

    @staticmethod
    def _place(device, *arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrays)

    def _shard_doc_major(self, bounds, per: int):
        """Each shard's doc-major block, [per, M] at the corpus-wide M (pad
        rows score 0), term ids int32 on the device (see
        PostingsIndex._build_doc_major)."""
        M = max((len(x) for x in self._doc_idx), default=1)
        out = []
        for dev, (lo, hi) in zip(self.mesh.devices, bounds):
            t, v, sc = self._doc_major_arrays(
                self._doc_idx[lo:hi], self._doc_val[lo:hi], per, M=M)
            out.append(self._place(dev, t.astype(np.int32), v, sc))
        return tuple(out)

    def shard_arrays(self):
        """Each shard's arrays in search order: phase 1, then its doc-major
        block when two-phase."""
        if self._doc_major is None:
            return list(self._built)
        return [b + dm for b, dm in zip(self._built, self._doc_major)]

    def max_results(self) -> int:
        """Largest k a search honours: each of the D shards rescores at most
        min(rescore_candidates, per) candidates."""
        n = len(self.doc_ids)
        if not self.rescore_candidates:
            return n
        per = self._shard_size or -(-n // self.n_shards)
        return min(n, self.n_shards * min(self.rescore_candidates, per))


class MeshShardedPostingsIndex(DocSharded, PostingsIndex):
    """Doc-sharded postings over a ``DeviceMesh`` (see the module
    docstring). Counterpart of ``splade_tpu``'s class of the same name:
    the truncation cap applies per term per shard, so a D-way index
    truncates no more than one device with the same P
    (``truncated_postings`` sums the shards); each shard has its own
    doc-major block at the corpus-wide M. The LSM delta and the tombstones
    stay on the host and shard-agnostic; ``compact()`` re-shards. It
    subclasses ``PostingsIndex``, so the engine's routing holds, and
    ``load(path, mesh=...)`` restores an archive onto a mesh."""

    def __init__(self, vocab_size: int, mesh, n_postings: int = 2048,
                 query_top_t: int = 32, batch_pad: int = 8,
                 approx: bool = True, rescore_candidates: int = 0,
                 phase1_acc: str = "auto", scoring: str = "auto"):
        super().__init__(vocab_size, n_postings=n_postings,
                         query_top_t=query_top_t, batch_pad=batch_pad,
                         approx=approx, rescore_candidates=rescore_candidates,
                         phase1_acc=phase1_acc, scoring=scoring,
                         device=mesh.devices[0])
        self._set_mesh(mesh)

    def build(self) -> None:
        n = len(self.doc_ids)
        if n == 0:
            raise ValueError("empty index")
        per, bounds = self._shard_bounds()
        V, P = self.vocab_size, self.n_postings
        built = []
        self.truncated_postings = 0
        for dev, (lo, hi) in zip(self.mesh.devices, bounds):
            if lo >= hi:  # empty tail shard: zero postings
                pd = np.zeros((V, P), np.int32)
                pw = np.zeros((V, P), np.float32)
                trunc = 0
            else:
                pd, pw, trunc = invert_to_postings(
                    self._doc_idx[lo:hi], self._doc_val[lo:hi], V, P)
            built.append(self._place(dev, pd, *quantize_postings(pw)))
            self.truncated_postings += trunc
        self._built = tuple(built)
        self._doc_major = (self._shard_doc_major(bounds, per)
                           if self.rescore_candidates else None)
        self._base_n = n
        self._delta_cache = None
        self._make_search()
        logger.info(
            "mesh postings index: %d docs over %d shards (%d/shard), P=%d, "
            "%.0f MB total", n, self.n_shards, per, P,
            self.memory_bytes() / 1e6)

    def _make_search(self) -> None:
        per = self._shard_size
        C = min(self.rescore_candidates, per) if self.rescore_candidates else 0
        search, search_two_phase = make_mesh_postings_search_fns(
            self.mesh, per, len(self.doc_ids), self.vocab_size, C,
            self.approx, self.acc_dtype(), self.resolved_scoring())
        fn = search_two_phase if C else search
        self._search_fn = lambda qi, qv, k: fn(self.shard_arrays(), qi, qv, k)
