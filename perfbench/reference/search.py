"""Plain two-phase postings search, float32, over the raw corpus.

The served index keeps, for each vocabulary term, its ``n_postings``
highest-impact postings (impacts ordered at float16 precision, ties by
document number), scores each query's candidates by the partial dot
product over those postings with the query's top ``query_top_t`` terms,
takes the ``rescore_candidates`` best and rescores them exactly against
the documents' whole vectors. That truncation is the index's documented
approximation, so the reference computes it too, but from the raw float32
impacts and without the index's int8 and bfloat16 roundings. Exact scores
are dot products of the reference's query vector with a document's raw
vector. Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.reference import modernbert as mb
from perfbench.reference.splade import encode_rows

DOC_BITS = 21


class Corpus:
    """The raw corpus on the card and its truncated postings."""

    def __init__(self, terms, vals, vocab_size: int, n_postings: int,
                 device):
        self.terms = torch.as_tensor(terms, device=device).long()
        self.vals = torch.as_tensor(vals, device=device).float()
        N, M = self.terms.shape
        if N >= 1 << DOC_BITS or vocab_size >= 1 << 16:
            raise ValueError("corpus too large for the postings key")
        self.N, self.V, self.P = N, vocab_size, n_postings
        half = self.vals.to(torch.float16).view(torch.int16).long() & 0xFFFF
        doc = torch.arange(N, device=device)[:, None].expand(N, M)
        key = ((self.terms << (16 + DOC_BITS)) | ((0xFFFF - half) << DOC_BITS)
               | doc).reshape(-1)
        key = torch.sort(key).values
        del half, doc
        term_of = key >> (16 + DOC_BITS)
        self.start = torch.searchsorted(
            term_of, torch.arange(vocab_size + 1, device=device))
        self.docs = key & ((1 << DOC_BITS) - 1)
        del key, term_of

    def postings(self, t: torch.Tensor) -> torch.Tensor:
        """[Q, T] terms -> [Q, T, P] documents, -1 past a term's list."""
        lo = self.start[t]
        n = (self.start[t + 1] - lo).clamp(max=self.P)
        off = torch.arange(self.P, device=t.device)
        idx = (lo[..., None] + off).clamp(max=self.docs.numel() - 1)
        return torch.where(off < n[..., None], self.docs[idx],
                           torch.full_like(idx, -1))

    def exact(self, q_dense: torch.Tensor, docs: torch.Tensor
              ) -> torch.Tensor:
        """q_dense [Q, V], docs [Q, C] -> [Q, C] exact scores."""
        Q, C = docs.shape
        t = self.terms[docs]                                   # [Q, C, M]
        qv = torch.gather(q_dense, 1, t.reshape(Q, -1)).reshape(t.shape)
        return (qv * self.vals[docs]).sum(-1)

    def weight(self, docs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """[Q, T, P] documents' raw impact of term t [Q, T]."""
        row = self.terms[docs.clamp(min=0)]                    # [Q, T, P, M]
        hit = row == t[..., None, None]
        w = (self.vals[docs.clamp(min=0)] * hit).sum(-1)
        return torch.where(docs >= 0, w, torch.zeros_like(w))


def query_vectors(p, cfg: dict, tok, queries: Sequence[str], max_length: int,
                  banned: Sequence[int], device, mm=mb.f32_mm
                  ) -> torch.Tensor:
    """[Q, V] SPLADE vectors of the queries, banned ids zeroed."""
    enc = tok(list(queries), max_length=max_length)
    with torch.no_grad():
        rep = encode_rows(p, cfg, torch.as_tensor(enc["input_ids"]).to(device),
                          torch.as_tensor(enc["attention_mask"]).to(device),
                          mm)
    rep[:, list(banned)] = 0.0
    return rep


def search(corpus: Corpus, rep: torch.Tensor, ks: Sequence[int], top_t: int,
           candidates: int, block: int = 16
           ) -> Tuple[List[List[Tuple[int, float]]], torch.Tensor]:
    """The two-phase search of each query vector at its k: (ranked
    [(doc, exact score)] a query, the [Q, V] vectors of its top-T
    terms)."""
    out, dense = [], torch.zeros_like(rep)
    for i in range(0, rep.shape[0], block):
        r = rep[i:i + block]
        vals, t = torch.topk(r, top_t, dim=1)
        q = torch.zeros_like(r).scatter_(1, t, vals)
        dense[i:i + block] = q
        docs = corpus.postings(t)                              # [Q, T, P]
        contrib = vals[..., None] * corpus.weight(docs, t)
        Q = r.shape[0]
        acc = torch.zeros((Q, corpus.N), device=r.device)
        acc.scatter_add_(1, docs.clamp(min=0).reshape(Q, -1),
                         contrib.reshape(Q, -1))
        cand = torch.topk(acc, min(candidates, corpus.N), dim=1).indices
        scores = corpus.exact(q, cand)
        for j in range(Q):
            k = ks[i + j]
            s, pos = torch.topk(scores[j], k)
            out.append(list(zip(cand[j][pos].tolist(), s.tolist())))
    return out, dense


def exact_of(corpus: Corpus, dense: torch.Tensor,
             served: List[List[int]]) -> List[Dict[int, float]]:
    """The exact score of every served document of each query that names
    a document of the corpus."""
    out = []
    for j, docs in enumerate(served):
        docs = [d for d in docs if 0 <= d < corpus.N]
        if not docs:
            out.append({})
            continue
        d = torch.as_tensor(docs, device=dense.device)
        s = corpus.exact(dense[j:j + 1], d[None])[0]
        out.append(dict(zip(docs, s.tolist())))
    return out
