"""Served two-phase postings results against the plain path over several
query streams, each document that differs traced back to phase 1, on the card.

    python scripts/served_postings_diff.py [--seeds 0 1 2] [--queries 32]

Builds ``chip_smoke.py`` phase 3's postings engine (22L/768/50K with seeded
random weights, the stand-in tokenizer, 1,000,000 synthetic documents plus
256 encoded ones, P=256, C=1000, T=64). For each seed it draws a stream of
queries, serves them (pool kernel, rescore kernel) and runs the plain path
(streamed pool, ``exact_rescore``) at k=10 and k=100, and applies phase 3's
pass rule (``compare_served``). For every document in one path's results and
not the other's it prints its rank in each, its exact score, and, under each
path's query vector, its rank and bf16 score in phase 1 beside the C-th
candidate's: phase 1's bf16 accumulation repeated here, which on the card is
an unordered ``scatter_add_``, so its last bits may differ from the served
call's. A document that one path's phase 1 keeps and the other's drops, with
a score within a few bf16 ulps of the C-th candidate's, is the cut-off
difference that two-phase search allows; anything else is a fault. Prints
the card's name and power limit first and writes the report to
``build/served_postings_diff.json`` (about two minutes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from splade_tpu_torch.benchmark.encoders import SparseEncoderV33  # noqa: E402
from splade_tpu_torch.models.modernbert import ModernBertConfig  # noqa: E402
from splade_tpu_torch.models.splade import SpladeEncoder  # noqa: E402
from splade_tpu_torch.ops.postings_index import PostingsIndex  # noqa: E402
from splade_tpu_torch.serving.engine import ServingEngine  # noqa: E402

C = 1000  # phase 2's candidates, as phase 3 serves them


def build_engine(seed: int):
    """Phase 3's postings engine, from ``seed``."""
    rng = np.random.default_rng(seed)
    tok = cs.CharTokenizer()
    model = SpladeEncoder(ModernBertConfig(), pool_impl="kernel",
                          device="cuda").init_weights(seed)
    model = model.to(torch.bfloat16).eval()
    terms, vals = cs.zipf_corpus_csr(rng, cs.POSTINGS_DOCS)
    index = PostingsIndex(cs.V, n_postings=256, query_top_t=64,
                          rescore_candidates=C, device="cuda")
    index.add_csr([f"syn{i}" for i in range(len(terms))], terms, vals)
    docs = cs.hangul_texts(rng, 256, 60)
    enc = SparseEncoderV33(model, tok, doc_top_k=64, device="cuda")
    index.add_batch([f"text{i}" for i in range(len(docs))],
                    enc.encode_documents(docs))
    index.build()
    return model, ServingEngine(model, tok, index, query_top_k=64,
                                device="cuda")


def run_path(engine, model, queries, served: bool):
    """{k: results} of engine.search_batch at k = 10 and 100, and the
    query vectors (q_idx, q_val) the fused search encoded, on the served
    route or the plain one."""
    model.pool_impl = "kernel" if served else "streamed"
    os.environ["SPLADE_RESCORE"] = "match" if served else "gather"
    try:
        results = {k: engine.search_batch(queries, k=k) for k in (10, 100)}
        ids, mask = engine.encoder.tokenize(list(queries),
                                            engine.query_max_length)
        with torch.no_grad():
            _, _, q_val, q_idx = engine._fused(
                *engine.index._built, *engine.index._doc_major, ids, mask,
                10)
    finally:
        model.pool_impl = "kernel"
        del os.environ["SPLADE_RESCORE"]
    return results, (q_idx, q_val)


def phase1_bf16(index, q_idx, q_val):
    """[B, N] phase-1 scores as the scatter scoring accumulates them: bf16
    contributions added into a bf16 accumulator."""
    post_docs, post_w, scale = index._built
    qi = q_idx.long()
    rows = post_docs[qi].long()
    contrib = (post_w[qi].to(torch.bfloat16)
               * (q_val.float() * scale[qi])[:, :, None].to(torch.bfloat16))
    B = qi.shape[0]
    acc = torch.zeros((B, len(index)), dtype=torch.bfloat16,
                      device=rows.device)
    return acc.scatter_add_(1, rows.reshape(B, -1),
                            contrib.reshape(B, -1))


def bf16_ulps(x: float, ref: float) -> float:
    """|x - ref| in bf16 ulps of ref (8 significant bits)."""
    ulp = 2.0 ** (np.floor(np.log2(max(abs(ref), 1e-30))) - 7)
    return abs(x - ref) / ulp


def trace(index, b, doc, p1, ranks):
    """Phase 1 of one query b for document index ``doc`` under each path's
    accumulator: its bf16 score and rank, the C-th candidate's score."""
    out = {}
    for path, acc in p1.items():
        row = acc[b].float()
        score = float(row[doc])
        cth = float(torch.topk(row, index.rescore_candidates).values[-1])
        out[path] = dict(phase1_rank=int((row > row[doc]).sum()),
                         phase1_bf16=score, cth_bf16=cth,
                         ulps_from_cth=bf16_ulps(score, cth),
                         final_rank=ranks[path])
    return out


def compare(name, served, plain, index, p1):
    """Phase 3's pass rule, and every document in one path's results only."""
    try:
        cs.compare_served(name, served, plain)
        passed = True
    except SystemExit as err:
        cs.log(f"  {name}: phase 3's rule fails: {err}")
        passed = False
    where = {d: i for i, d in enumerate(index.doc_ids)}
    diffs = []
    for b, (sr, pr) in enumerate(zip(served, plain)):
        s_ids = [d for d, _ in sr]
        p_ids = [d for d, _ in pr]
        score = dict(pr + sr)
        for d in sorted(set(s_ids) ^ set(p_ids)):
            ranks = {"served": s_ids.index(d) if d in s_ids else None,
                     "plain": p_ids.index(d) if d in p_ids else None}
            row = dict(query=b, doc=d, score=score[d],
                       kth_score_plain=pr[-1][1] if pr else 0.0,
                       kth_score_served=sr[-1][1] if sr else 0.0,
                       **trace(index, b, where[d], p1, ranks))
            # one path's phase 1 drops it: rank >= C there
            dropped = [p for p in ("served", "plain")
                       if row[p]["phase1_rank"] >= index.rescore_candidates]
            # the path whose results lack it, and that path's k-th score
            lacking = "served" if ranks["served"] is None else "plain"
            row["cause"] = (
                "candidate cut-off" if dropped and all(
                    row[p]["ulps_from_cth"] <= 4 for p in dropped)
                else "k-th result tie" if abs(
                    row["score"] - row[f"kth_score_{lacking}"])
                <= cs.SERVE_RTOL * max(abs(row["score"]), 1e-6)
                else "unexplained")
            cs.log(f"  {name} query {b}: {d} served rank "
                   f"{ranks['served']}, plain rank {ranks['plain']}, exact "
                   f"score {row['score']:.4f} (k-th: plain "
                   f"{row['kth_score_plain']:.4f}, served "
                   f"{row['kth_score_served']:.4f}); phase 1 "
                   + "; ".join(
                       f"{p}: rank {row[p]['phase1_rank']} bf16 "
                       f"{row[p]['phase1_bf16']:.4f} against the C-th "
                       f"{row[p]['cth_bf16']:.4f} "
                       f"({row[p]['ulps_from_cth']:.1f} ulps)"
                       for p in ("served", "plain"))
                   + f": {row['cause']}")
            diffs.append(row)
    return dict(passed=passed, differing_docs=diffs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--build-seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("served_postings_diff: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    model, engine = build_engine(args.build_seed)
    index = engine.index
    cs.log(f"postings engine: {len(index)} docs, scoring "
           f"{index.resolved_scoring()}, C={C}")
    report = {}
    for seed in args.seeds:
        queries = cs.hangul_texts(np.random.default_rng([seed, 3]),
                                  args.queries, 6)
        served, q_served = run_path(engine, model, queries, True)
        plain, q_plain = run_path(engine, model, queries, False)
        same_terms = [bool(torch.equal(a.sort().values, b.sort().values))
                      for a, b in zip(q_served[0], q_plain[0])]
        p1 = {"served": phase1_bf16(index, *q_served),
              "plain": phase1_bf16(index, *q_plain)}
        cs.log(f"seed {seed}: {args.queries} queries; the two paths' query "
               f"vectors hold the same terms in {sum(same_terms)} of "
               f"{len(same_terms)}")
        report[seed] = {f"k={k}": compare(f"seed {seed} k={k}", served[k],
                                          plain[k], index, p1)
                        for k in (10, 100)}
        report[seed]["same_query_terms"] = same_terms
    out = ROOT / "build" / "served_postings_diff.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    causes = [row["cause"] for r in report.values()
              for key, v in r.items() if key.startswith("k=")
              for row in v["differing_docs"]]
    cs.log(json.dumps({"seeds": args.seeds, "differing_docs": len(causes),
                       "by_cause": {c: causes.count(c) for c in set(causes)},
                       "phase3_rule_passed": {
                           seed: all(v["passed"] for key, v in r.items()
                                     if key.startswith("k="))
                           for seed, r in report.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
