"""Hard-negative mining (the port of ``splade_tpu/preprocessing/miners.py``).

Two miners, mirroring the reference's pair:

- ``TfidfHardNegativeMiner`` — lexical char-n-gram TF-IDF similarity search
  (reference: scripts/mine_hard_negatives.py:85-549 used scikit-learn
  char_wb 2-3-grams, 30K features, L2-normalized, chunked argpartition
  top-k). This implementation is scikit-free: hashed char-n-gram features
  into a fixed-width scipy CSR, same L2-normalize + chunked matmul + top-k
  selection, same "fill missing negative fields, atomic temp-file writes"
  shard updating. A copy of the JAX package's: host work, bitwise the same
  features and ids.
- ``EncoderHardNegativeMiner`` — embedding-space mining in a similarity band
  (reference: src/preprocessing/miners/bge_m3_miner.py:22-329 FAISS band
  search; scripts/mine_multi_negatives.py:45-481 GPU torch.mm rank-window
  selection). Works with any encoder exposing ``encode(texts) -> [N, D]``
  (a numpy array or a torch tensor). The L2-normalised embeddings stay on
  the miner's device (``cuda`` unless the caller asks for the CPU); the
  search is one chunked f32 ``[Q, D] x [D, N]`` product and
  ``torch.topk(sorted=True)`` where the JAX package loops over queries in
  numpy. The selection is the reference's; tied similarities may come out
  in another order than numpy's ``argpartition`` / ``argsort``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import sparse

from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


class TfidfHardNegativeMiner:
    def __init__(
        self,
        num_features: int = 1 << 15,
        ngram_range: Tuple[int, int] = (2, 3),
        top_k: int = 1,
        chunk_size: int = 2048,
        exclude_self: bool = True,
    ):
        self.num_features = num_features
        self.ngram_range = ngram_range
        self.top_k = top_k
        self.chunk_size = chunk_size
        self.exclude_self = exclude_self
        self._idf: Optional[np.ndarray] = None

    # ------------------------------------------------------- features
    def _grams(self, text: str):
        t = f" {text.strip().lower()} "
        lo, hi = self.ngram_range
        for n in range(lo, hi + 1):
            for i in range(max(len(t) - n + 1, 0)):
                yield t[i:i + n]

    def _hash(self, gram: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(gram.encode("utf-8"), digest_size=4).digest(),
            "little") % self.num_features

    def _count_matrix(self, texts: Sequence[str]) -> sparse.csr_matrix:
        indptr, cols, data = [0], [], []
        for t in texts:
            counts: Dict[int, int] = {}
            for g in self._grams(t):
                h = self._hash(g)
                counts[h] = counts.get(h, 0) + 1
            cols.extend(counts.keys())
            data.extend(counts.values())
            indptr.append(len(cols))
        return sparse.csr_matrix(
            (np.asarray(data, np.float32), np.asarray(cols, np.int64),
             np.asarray(indptr, np.int64)),
            shape=(len(texts), self.num_features))

    def fit_transform(self, texts: Sequence[str]) -> sparse.csr_matrix:
        """TF-IDF with smoothed idf, L2-normalized rows (dot = cosine)."""
        tf = self._count_matrix(texts)
        n = tf.shape[0]
        # document frequency: count each column once per row
        df = (tf > 0).sum(axis=0).A1
        self._idf = np.log((1 + n) / (1 + df)) + 1.0
        mat = tf.multiply(self._idf[None, :]).tocsr()
        norms = np.sqrt(mat.multiply(mat).sum(axis=1)).A1
        norms[norms == 0] = 1.0
        inv = sparse.diags(1.0 / norms)
        return (inv @ mat).tocsr()

    # ---------------------------------------------------------- mining
    def mine(self, queries: Sequence[str], corpus: Sequence[str],
             k: Optional[int] = None) -> List[List[int]]:
        """Top-k corpus indices per query by TF-IDF cosine (chunked)."""
        kq = k or self.top_k
        all_texts = list(queries) + list(corpus)
        # exclude_self: map text -> corpus positions once (not O(B*N) string
        # compares per chunk)
        text_pos = {}
        if self.exclude_self:
            for c, t in enumerate(corpus):
                text_pos.setdefault(t, []).append(c)
        mat = self.fit_transform(all_texts)
        q_mat = mat[: len(queries)]
        c_mat = mat[len(queries):]
        out: List[List[int]] = []
        for start in range(0, q_mat.shape[0], self.chunk_size):
            block = q_mat[start:start + self.chunk_size]
            scores = (block @ c_mat.T).toarray()  # [b, N]
            if self.exclude_self:
                # queries drawn from the corpus: a doc identical to the
                # query scores cosine ~1.0 — mask exact text matches so the
                # query never surfaces as its own "hard negative"
                for r in range(block.shape[0]):
                    for c in text_pos.get(all_texts[start + r], ()):
                        scores[r, c] = -1.0
            kk = min(kq, scores.shape[1])
            top = np.argpartition(-scores, kk - 1, axis=1)[:, :kk]
            for r in range(top.shape[0]):
                row = top[r][np.argsort(-scores[r, top[r]])]
                out.append([int(i) for i in row][:kq])
        return out

    def fill_missing_negatives(self, shard_path: str,
                               corpus: Optional[Sequence[str]] = None) -> int:
        """Fill rows lacking a 'negative' with a TF-IDF hard negative; write
        atomically via a temp file (reference: mine_hard_negatives.py flow)."""
        rows = []
        with open(shard_path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line))
        if corpus is None:
            corpus = [r["positive"] for r in rows]
        need = [i for i, r in enumerate(rows)
                if not r.get("negative") and not r.get("negatives")]
        if not need:
            return 0
        # +1 slack: the top hit is often the positive itself, which the
        # loop below filters out
        mined = self.mine([rows[i]["query"] for i in need], corpus,
                          k=self.top_k + 1)
        filled = 0
        for i, cand in zip(need, mined):
            pos = rows[i]["positive"]
            neg = next((corpus[c] for c in cand if corpus[c] != pos), None)
            if neg:
                rows[i]["negative"] = neg
                filled += 1
        fd, tmp = tempfile.mkstemp(dir=str(Path(shard_path).parent))
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            for r in rows:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")
        os.replace(tmp, shard_path)
        logger.info("filled %d/%d negatives in %s", filled, len(need), shard_path)
        return filled


#: queries a similarity product takes at once: [chunk, N] f32 scores
QUERY_CHUNK = 1024


class EncoderHardNegativeMiner:
    """Embedding-space negative mining with a similarity band or rank window.

    band mode (reference bge_m3_miner): keep candidates with
    min_score <= sim <= max_score.
    rank-window mode (reference mine_multi_negatives): take k candidates
    from retrieval ranks [rank_lo, rank_hi), excluding the positive.
    """

    def __init__(self, encoder, batch_size: int = 256,
                 device: DeviceLike = None):
        self.encoder = encoder
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def _encode(self, texts: Sequence[str]) -> torch.Tensor:
        """[N, D] f32 unit rows on the miner's device (a zero row stays
        zero)."""
        out = []
        for i in range(0, len(texts), self.batch_size):
            emb = self.encoder.encode(list(texts[i:i + self.batch_size]))
            out.append(torch.as_tensor(emb).to(self.device, torch.float32))
        emb = (torch.cat(out) if out
               else torch.zeros((0, 1), dtype=torch.float32,
                                device=self.device))
        norms = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
        return emb / torch.where(norms == 0, torch.ones_like(norms), norms)

    @staticmethod
    def _chunks(q: torch.Tensor, c: torch.Tensor):
        """(first row, [chunk, N] similarities) over the queries."""
        for start in range(0, q.shape[0], QUERY_CHUNK):
            yield start, q[start:start + QUERY_CHUNK] @ c.T

    def mine_band(self, queries: Sequence[str], corpus: Sequence[str],
                  min_score: float = 0.3, max_score: float = 0.85,
                  k: int = 1) -> List[List[int]]:
        q = self._encode(queries)
        c = self._encode(corpus)
        out: List[List[int]] = []
        kk = min(k, c.shape[0])
        for _, sims in self._chunks(q, c):
            band = (sims >= min_score) & (sims <= max_score)
            in_band = band.sum(dim=1).clamp(max=kk).tolist()
            top = torch.topk(sims.masked_fill(~band, -torch.inf), kk,
                             dim=1, sorted=True).indices.tolist()
            out.extend([int(j) for j in row[:n]]
                       for row, n in zip(top, in_band))
        return out

    def mine_rank_window(self, queries: Sequence[str], corpus: Sequence[str],
                         positives: Sequence[str],
                         rank_lo: int = 10, rank_hi: int = 50,
                         k: int = 7, search_k: int = 100) -> List[List[int]]:
        q = self._encode(queries)
        c = self._encode(corpus)
        out: List[List[int]] = []
        kk = min(search_k, c.shape[0])
        for start, sims in self._chunks(q, c):
            top = torch.topk(sims, kk, dim=1, sorted=True).indices
            for r, row in enumerate(top[:, rank_lo:rank_hi].tolist()):
                pos = positives[start + r]
                out.append([int(j) for j in row if corpus[j] != pos][:k])
        return out
