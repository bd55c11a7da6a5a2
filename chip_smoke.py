"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. The card's name and power limit; the Hopper kernels built from
   ``splade_tpu_torch/csrc`` with their ptxas register/shared-memory/spill
   report.
2. Each kernel against its plain PyTorch version at the serving path's
   shapes, in bf16 on the card: the fused SPLADE pool at query encode
   (B=32, S=64) and document encode (B=32, S=256) with H=768, V=50,000 and
   a fully padded row; the exact rescore at B=32, C=1000, M=64, T=64 over a
   1M-document doc-major block. Times by CUDA events, the bound from the
   shapes, and for the pool a library yardstick (torch.matmul + amax).
3. The serving path at full width (22 layers, 768 hidden, 50K vocab) with
   seeded random weights and a character-level stand-in tokenizer: a
   two-phase PostingsIndex over 1,000,000 synthetic documents plus a few
   hundred model-encoded ones, and a dense int8 engine over 10,000
   documents, each behind the HTTP server; /healthz, /search (k=10, 100),
   /encode, /index then /search through the LSM delta. The batched /search
   results, and the indexed text documents' vectors, are held against the
   port's plain path (pool_impl="streamed", exact_rescore) on the same
   inputs. The kernels' launch counts are set to 0 before this phase and
   read after it, and per served request and batch around the
   single-query requests. Then one warmed search batch
   of 8 and of 32 queries per engine under torch.profiler: wall time,
   device busy time and idle share, and the kernels that take most time.

The last two lines are the kernels' JSON and the run's JSON.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_FP32_OPS = 67e12      # non-tensor f32/int32 lane operations
H100_BYTES = 3.35e12       # HBM3 bandwidth

V = 50_000
POSTINGS_DOCS = 1_000_000  # synthetic documents of the postings engine
POOL_TOL = 1e-3      # bf16 products are exact in f32; only sum order differs
RESCORE_TOL = 1e-4   # the reference's own rescore tolerance
# served vs plain path, relative to each query's top score (or each
# document's largest weight): f32 sum order alone gives about 1e-6, and a
# dropped bias or a wrong term in a score moves it by far more than 1e-4
SERVE_RTOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- stand-ins
class CharTokenizer:
    """Deterministic character-level stand-in for the A.X-Encoder
    tokenizer (which is not in the repository): one id per non-space
    character, ids 0-3 special, [PAD] = 0."""

    pad_token_id = 0
    all_special_ids = [0, 1, 2, 3]

    def __len__(self):
        return V

    def get_vocab(self):
        return {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[MASK]": 3}

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=64, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [4 + ord(c) % (V - 4) for c in t if not c.isspace()]
            codes = codes[:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def hangul_texts(rng, n: int, words: int) -> list:
    stems = ["".join(chr(0xAC00 + int(x)) for x in rng.integers(0, 11172, 2))
             for _ in range(400)]
    return [" ".join(stems[j] for j in rng.integers(0, len(stems), words))
            for _ in range(n)]


def zipf_corpus_csr(rng, n_docs: int, nnz: int = 54):
    """A synthetic corpus after the reference benches' generator
    (``splade_tpu/utils/synth.py``: Zipf(1.3) term ids mod the vocabulary,
    |N(0,1)|+0.1 impacts, 54 draws per document), with one departure. That
    generator keeps repeated draws, so a row holds about 29 distinct ids and
    the Zipf head repeats within it. A sparse vector holds each term once,
    so here a term drawn twice in one row is redrawn uniformly until the
    row's 54 ids are distinct (rows come out sorted). About 25 draws a row
    move from the Zipf head to uniform terms, which lengthens the postings
    of the vocabulary's tail against the reference's corpus."""
    terms = (rng.zipf(1.3, size=(n_docs, nnz)) % V).astype(np.int32)
    while True:
        terms.sort(axis=1)
        dup = np.zeros(terms.shape, bool)
        dup[:, 1:] = terms[:, 1:] == terms[:, :-1]
        n_dup = int(dup.sum())
        if not n_dup:
            break
        terms[dup] = rng.integers(0, V, n_dup)
    vals = (np.abs(rng.normal(size=(n_docs, nnz))) + 0.1).astype(np.float32)
    return terms, vals


# ----------------------------------------------------------------- timing
def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / H100_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 2
def check_pool(torch, model, tok, rng, B: int, S: int) -> dict:
    """The wrapper ``fused_splade_pool`` against its plain version at one
    encode shape; the timed closure calls the C entry alone."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import (float_key,
                                                   fused_splade_pool,
                                                   fused_splade_pool_plain)

    enc = tok(hangul_texts(rng, B, S), max_length=S)
    ids = torch.from_numpy(enc["input_ids"]).cuda()
    mask = torch.from_numpy(enc["attention_mask"]).cuda()
    lens = torch.from_numpy(rng.integers(1, S + 1, B)).cuda()
    mask = mask * (torch.arange(S, device="cuda")[None] < lens[:, None])
    mask[-1] = 0                                  # a fully padded row
    with torch.no_grad():
        h = model.mlm.head_transform(model.mlm.encode(ids, mask)).contiguous()
    w, bias_param = model.mlm.decoder_weights()
    w, bias = w.detach(), bias_param.detach().float().contiguous()
    maskf = mask.float().contiguous()
    H = h.shape[-1]
    lib = _cuda.library()
    m = torch.empty((B, V), dtype=torch.float32, device="cuda")
    neg_key = int(float_key(torch.tensor(-1e30)))
    pos_key = torch.full((B, S), neg_key, dtype=torch.int32, device="cuda")

    def kernel():
        pos_key.fill_(neg_key)
        _cuda.check(lib.splade_fused_pool_fwd(
            h.data_ptr(), w.data_ptr(), bias.data_ptr(), maskf.data_ptr(),
            m.data_ptr(), pos_key.data_ptr(), B, S, H, V,
            torch.cuda.current_stream().cuda_stream), "splade_fused_pool_fwd")

    with torch.no_grad():
        # the model's own (bf16) bias and the int mask, as the encoder
        # passes them: the wrapper does the conversions
        pooled, tw = fused_splade_pool(h, w, bias_param, mask)
        empty, empty_tw = fused_splade_pool(h[:0], w, bias_param, mask[:0])
        m_ref, pos_ref = fused_splade_pool_plain(h, w, bias, maskf)
    torch.cuda.synchronize()
    ref_pooled = torch.log1p(torch.relu(m_ref))
    ref_tw = torch.log1p(torch.relu(pos_ref)) * maskf
    err = max(float((pooled - ref_pooled).abs().max()),
              float((tw - ref_tw).abs().max()))
    padded_zero = (float(pooled[-1].abs().max()) == 0.0
                   and float(tw[-1].abs().max()) == 0.0)
    log(f"  pool B={B} S={S}: max |err| {err:.3e} (tol {POOL_TOL}), "
        f"padded row zero: {padded_zero}, nnz/row "
        f"{float((pooled > 0).sum(1)[:-1].float().mean()):.0f}")
    if not (err <= POOL_TOL and padded_zero):
        raise SystemExit(f"fused pool kernel disagrees (B={B}, S={S})")
    if empty.shape != (0, V) or empty_tw.shape != (0, S):
        raise SystemExit(f"fused pool on an empty batch gave "
                         f"{tuple(empty.shape)}, {tuple(empty_tw.shape)}")

    def library():
        logits = torch.matmul(h.view(B * S, H), w.T).view(B, S, V)
        return (logits.float() + bias).masked_fill(
            maskf[:, :, None] == 0, -1e30).amax(1)

    with torch.no_grad():
        ms = cuda_ms(torch, kernel, iters=20)
        plain_ms = cuda_ms(torch, lambda: fused_splade_pool_plain(
            h, w, bias, maskf), iters=3, warmup=1)
        library_ms = cuda_ms(torch, library, iters=5, warmup=1)
    valid = float(maskf.sum())
    ops = 2.0 * valid * H * V
    moved = h.numel() * 2 + w.numel() * 2 + V * 4 + B * S * 4 + B * V * 4 \
        + B * S * 4
    bound_ms, bound_by = bound(moved, ops, H100_BF16_FLOPS)
    log(f"  pool B={B} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ops:.3e} FLOP over {valid:.0f} valid tokens, {moved / 1e6:.1f} MB)")
    return dict(shape=f"B={B} S={S} H={H} V={V}", max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def check_rescore(torch, enc, rng, syn_terms, syn_vals, B: int = 32,
                  C: int = 1000, M: int = 64, T: int = 64) -> dict:
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.postings_index import (exact_rescore,
                                                     sparse_query_dense)
    from splade_tpu_torch.ops.rescore_kernel import (rescore_match,
                                                     rescore_match_plain,
                                                     rescore_match_rows)

    N, nnz = syn_terms.shape
    # doc-major block as PostingsIndex builds it: pad id V, int8 + scale
    terms = np.full((N, M), V, np.int32)
    terms[:, :nnz] = syn_terms
    scale = (syn_vals.max(1) / 127.0).astype(np.float32)
    q8 = np.zeros((N, M), np.int8)
    q8[:, :nnz] = np.clip(np.round(syn_vals / scale[:, None]), -127, 127)
    d_terms = torch.from_numpy(terms).cuda()
    d_vals = torch.from_numpy(q8).cuda()
    d_scale = torch.from_numpy(scale).cuda()
    q_vecs = enc.encode_queries(hangul_texts(rng, B, 12))
    q_idx = torch.full((B, T), 0, dtype=torch.int32)
    q_val = torch.zeros((B, T), dtype=torch.float32)
    for b, (qi, qv) in enumerate(q_vecs):
        q_idx[b, :len(qi)] = torch.from_numpy(qi[:T])
        q_val[b, :len(qv)] = torch.from_numpy(qv[:T])
    cand = torch.from_numpy(rng.integers(0, N, (B, C)))
    # the last 32 query slots take term j of candidate j (j < 32), so
    # scores are not all zero
    q_idx[:, T - 32:] = torch.from_numpy(
        terms[cand[:, :32].numpy(), np.arange(32)])
    q_idx, q_val, cand = q_idx.cuda(), q_val.cuda(), cand.cuda()
    args = (d_terms, d_vals, d_scale, q_idx, q_val, cand)
    out = rescore_match(*args)
    out_rows = rescore_match_rows(*args)
    ref = exact_rescore(d_terms, d_vals, d_scale,
                        sparse_query_dense(q_idx, q_val, V), cand)
    plain = rescore_match_plain(*args)
    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o in (out, out_rows)
              for r in (ref, plain))
    log(f"  rescore B={B} C={C} M={M} T={T} N={N}: max |err| {err:.3e} "
        f"(tol {RESCORE_TOL}), nonzero scores {int((ref > 0).sum())}")
    if not err <= RESCORE_TOL:
        raise SystemExit("rescore kernel disagrees with exact_rescore")
    lib = _cuda.library()
    ci = cand.to(torch.int32)
    res = torch.empty((B, C), dtype=torch.float32, device="cuda")

    def kernel():
        _cuda.check(lib.splade_rescore_match(
            d_terms.data_ptr(), d_vals.data_ptr(), d_scale.data_ptr(),
            q_idx.data_ptr(), q_val.data_ptr(), ci.data_ptr(), res.data_ptr(),
            N, B, C, M, T, torch.cuda.current_stream().cuda_stream),
            "splade_rescore_match")

    ms = cuda_ms(torch, kernel, iters=200, warmup=5)
    plain_ms = cuda_ms(torch, lambda: rescore_match_plain(*args), iters=5,
                       warmup=1)
    gather_ms = cuda_ms(torch, lambda: exact_rescore(
        d_terms, d_vals, d_scale, sparse_query_dense(q_idx, q_val, V), cand),
        iters=20, warmup=2)
    moved = B * C * 8 + B * C * M * 5 + B * C * 4 + B * T * 8 + B * C * 4
    ops = float(B) * C * M * T
    bound_ms, bound_by = bound(moved, ops, H100_FP32_OPS)
    log(f"  rescore: kernel {ms:.5f} ms, plain match {plain_ms:.4f} ms, "
        f"plain gather (exact_rescore) {gather_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}: {moved / 1e6:.2f} MB, "
        f"{ops:.3e} compares)")
    return dict(shape=f"B={B} C={C} M={M} T={T} N={N}", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, gather_ms=gather_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# ------------------------------------------------------------ phase 3
def _http(addr, method, path, payload=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    body = json.dumps(payload).encode() if payload is not None else None
    t0 = time.perf_counter()
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    dt = time.perf_counter() - t0
    conn.close()
    if resp.status != 200:
        raise SystemExit(f"{method} {path} -> {resp.status}: {out}")
    return out, dt


def drive(name: str, engine, model, queries, doc_text: str) -> dict:
    """Serve ``engine`` over HTTP and send the request mix: batched
    /search at k=10 and k=100 (held against the plain path), single-query
    /search from 8 concurrent clients (timed), /encode, /index and a
    /search that must find the new document. Returns latency stats."""
    from splade_tpu_torch.ops.fused_splade import fused_splade_pool
    from splade_tpu_torch.ops.rescore_kernel import rescore_match
    from splade_tpu_torch.serving.server import SearchService, create_server

    service = SearchService(engine, max_batch_size=32, max_wait_ms=5.0,
                            warmup=True)
    server = create_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    lat = []
    try:
        health, _ = _http(addr, "GET", "/healthz")
        assert health["docs"] == engine.num_docs, health
        served = {}
        for k in (10, 100):
            out, dt = _http(addr, "POST", "/search",
                            {"queries": queries, "k": k})
            served[k] = [[(r["doc_id"], r["score"]) for r in rs]
                         for rs in out["results"]]
            assert all(0 < len(r) <= k for r in served[k]), name
        compare_with_plain_path(name, engine, model, queries, served)
        # single-query requests from 8 concurrent clients, with the kernels'
        # launches and the batches they rode in counted around them
        pool0, resc0 = fused_splade_pool.launches, rescore_match.launches
        batches0 = service.batcher.stats()["batches"]

        def client(i):
            for q in queries[i::8]:
                for k in (10, 100):
                    _, dt = _http(addr, "POST", "/search", {"query": q, "k": k})
                    lat.append(dt)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        assert not any(c.is_alive() for c in clients)
        assert len(lat) == 2 * len(queries), len(lat)
        batches = service.batcher.stats()["batches"] - batches0
        per = {kname: dict(launches=n, per_request=n / len(lat),
                           per_batch=n / batches)
               for kname, n in (
                   ("fused_splade_pool", fused_splade_pool.launches - pool0),
                   ("rescore_match", rescore_match.launches - resc0))}
        enc, _ = _http(addr, "POST", "/encode",
                       {"texts": queries[:2], "queries": True})
        assert all(len(v) > 0 for v in enc["vectors"]), name
        added, _ = _http(addr, "POST", "/index",
                         {"docs": [{"id": "fresh-doc", "text": doc_text}]})
        assert added["added"] == 1, added
        after, _ = _http(addr, "POST", "/search",
                         {"query": doc_text, "k": 10})
        ids = [r["doc_id"] for r in after["results"][0]]
        assert "fresh-doc" in ids, (name, ids)
        stats, _ = _http(addr, "GET", "/stats")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    summary = dict(
        p50_ms=float(np.percentile(lat_ms, 50)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        requests=len(lat), batches=batches,
        fresh_doc_rank=ids.index("fresh-doc"),
        mean_batch=stats["mean_batch_size"], kernel_launches=per)
    log(f"  {name}: {engine.num_docs} docs, single-query /search latency "
        f"p50 {summary['p50_ms']:.2f} ms p99 {summary['p99_ms']:.2f} ms over "
        f"{len(lat)} requests in {batches} batches; kernel launches "
        + ", ".join(f"{k} {v['launches']} ({v['per_request']:.3f}/request, "
                    f"{v['per_batch']:.2f}/batch)" for k, v in per.items())
        + f"; /index doc found at rank {summary['fresh_doc_rank']}")
    return summary


def profile_batch(torch, name: str, engine, queries) -> dict:
    """Where one warmed search batch of len(queries) at k=100 spends its
    time: host wall clock (to a synchronize) against the union of the
    device's kernel and copy intervals in a torch.profiler trace, and the
    kernels that take most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.search_batch(queries, k=100)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search_batch(queries, k=100)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, kname in spans:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        by_name[kname] = by_name.get(kname, 0.0) + (end - start)
    if not spans:
        log(f"  {name} B={len(queries)}: wall {wall_ms:.2f} ms; the profiler "
            "saw no device activity, device time not measured")
        return dict(batch=len(queries), wall_ms=wall_ms, device_busy_ms=None)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = dict(batch=len(queries), wall_ms=wall_ms,
               device_busy_ms=busy_us / 1e3,
               device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
               device_ops=len(spans),
               top_kernels_ms={k[:60]: v / 1e3 for k, v in top})
    log(f"  {name} B={len(queries)} k=100 batch: wall {wall_ms:.2f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms (idle {out['device_idle_share']:.0%}) "
        f"over {len(spans)} device ops; top: "
        + ", ".join(f"{k[:40]} {v / 1e3:.3f}" for k, v in top[:5]))
    return out


def compare_with_plain_path(name, engine, model, queries, served) -> None:
    """Run the same queries through the port's plain path (pool_impl
    'streamed', rescore 'gather' = exact_rescore) and hold the served
    results against them. No kernel launches here."""
    os.environ["SPLADE_RESCORE"] = "gather"
    model.pool_impl = "streamed"
    try:
        for k, got in served.items():
            compare_served(f"{name} k={k}", got,
                           engine.search_batch(queries, k=k))
    finally:
        model.pool_impl = "kernel"
        del os.environ["SPLADE_RESCORE"]


def compare_doc_encode(torch, enc, model, texts) -> float:
    """The document vectors the postings engine indexed (pool_impl
    'kernel', S = doc_max_length) against the plain path's on the same
    texts, as dense [B, V] rows: within SERVE_RTOL of each row's largest
    weight. Returns the largest relative difference."""
    worst = 0.0
    for i in range(0, len(texts), enc.batch_size):
        batch = enc.tokenize(texts[i:i + enc.batch_size], enc.doc_max_length)
        got = enc.encode_tensor(*batch)
        model.pool_impl = "streamed"
        try:
            want = enc.encode_tensor(*batch)
        finally:
            model.pool_impl = "kernel"
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-6)
        worst = max(worst, float(((got - want).abs() / scale).max()))
    log(f"  document encode S={enc.doc_max_length}, {len(texts)} docs: "
        f"kernel == plain path (max relative diff {worst:.2e}, "
        f"tol {SERVE_RTOL})")
    if not worst <= SERVE_RTOL:
        raise SystemExit("document vectors differ from the plain path")
    return worst


def compare_served(name, served, plain) -> None:
    """Same ids where scores are separated by more than SERVE_RTOL; tied
    groups as sets; scores within SERVE_RTOL."""
    worst = 0.0
    for sr, pr in zip(served, plain):
        assert len(sr) == len(pr), name
        s = np.array([x for _, x in sr])
        p = np.array([x for _, x in pr])
        tol = SERVE_RTOL * max(float(np.abs(p).max(initial=0)), 1e-6)
        worst = max(worst, float(np.abs(s - p).max(initial=0)) / max(
            float(np.abs(p).max(initial=0)), 1e-6))
        if not np.allclose(s, p, rtol=0, atol=tol):
            raise SystemExit(f"{name}: served scores differ from the plain "
                             f"path: {s[:5]} vs {p[:5]}")
        start = 0
        while start < len(p):
            end = start + 1
            while end < len(p) and abs(p[end] - p[end - 1]) <= tol:
                end += 1
            if end < len(p) and ({d for d, _ in sr[start:end]}
                                 != {d for d, _ in pr[start:end]}):
                raise SystemExit(f"{name}: served ids differ from the plain "
                                 f"path at ranks {start}-{end}")
            start = end
    log(f"  {name}: served == plain path (max relative score diff "
        f"{worst:.2e}, tol {SERVE_RTOL})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import fused_splade_pool
    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.ops.rescore_kernel import rescore_match
    from splade_tpu_torch.serving.engine import (ServingEngine,
                                                 build_engine_from_docs)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"tf32 matmul off")

    # ---- 1. build
    t0 = time.perf_counter()
    _cuda.library()
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(sources {[s.name for s in _cuda.sources()]})")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())

    rng = np.random.default_rng(args.seed)
    tok = CharTokenizer()
    log("tokenizer: a deterministic character-level stand-in defined in "
        "chip_smoke.py (the A.X-Encoder tokenizer is not in the repository)")
    model = SpladeEncoder(ModernBertConfig(), pool_impl="kernel",
                          device="cuda").init_weights(args.seed)
    model = model.to(torch.bfloat16).eval()
    log(f"model: SpladeEncoder 22L/768/50K, seeded random weights "
        f"(seed {args.seed}), bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")

    # ---- 2. kernels against their plain versions
    log("[2] kernels vs plain versions (bf16 on the card)")
    t0 = time.perf_counter()
    syn_terms, syn_vals = zipf_corpus_csr(rng, POSTINGS_DOCS)
    pool_q = check_pool(torch, model, tok, rng, 32, 64)
    pool_d = check_pool(torch, model, tok, rng, 32, 256)
    probe = SparseEncoderV33(model, tok, query_top_k=64, device="cuda")
    resc = check_rescore(torch, probe, rng, syn_terms, syn_vals)
    log(f"[2] done in {time.perf_counter() - t0:.1f} s")

    # ---- 3. the serving path
    log("[3] serving path")
    queries = hangul_texts(rng, 32, 6)
    pool_docs = hangul_texts(rng, 256, 60)
    dense_docs = hangul_texts(rng, 10_000, 80)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_splade_pool.launches = 0
    rescore_match.launches = 0
    t0 = time.perf_counter()
    index = PostingsIndex(V, n_postings=256, query_top_t=64,
                          rescore_candidates=1000, device="cuda")
    index.add_csr([f"syn{i}" for i in range(len(syn_terms))], syn_terms,
                  syn_vals)
    doc_enc = SparseEncoderV33(model, tok, doc_top_k=64, device="cuda")
    index.add_batch([f"text{i}" for i in range(len(pool_docs))],
                    doc_enc.encode_documents(pool_docs))
    index.build()
    postings = ServingEngine(model, tok, index, query_top_k=64,
                             device="cuda")
    log(f"  postings engine: {len(index)} docs, scoring "
        f"{index.resolved_scoring()}, {index.memory_bytes() / 1e6:.0f} MB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense = build_engine_from_docs(
        model, tok, [(f"dense{i}", t) for i, t in enumerate(dense_docs)],
        int8=True, doc_top_k=256, index_type="dense", query_top_k=64,
        device="cuda")
    log(f"  dense engine: {dense.num_docs} docs int8, built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pool_at_indexed = fused_splade_pool.launches
    serving = {
        "postings": drive("postings", postings, model, queries, pool_docs[3]),
        "dense": drive("dense", dense, model, queries, dense_docs[5])}
    torch.cuda.synchronize()
    launches = {"fused_splade_pool": fused_splade_pool.launches,
                "rescore_match": rescore_match.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[3] requests done in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches on the path {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"kernel {name} was not launched on the path")
    if launches["fused_splade_pool"] <= pool_at_indexed:
        raise SystemExit("the pool kernel encoded no served query")
    doc_encode_diff = compare_doc_encode(torch, doc_enc, model, pool_docs)
    profiles = {f"{name} B={b}": profile_batch(torch, name, engine,
                                                queries[:b])
                for name, engine in (("postings", postings), ("dense", dense))
                for b in (8, 32)}

    kernels = [
        dict(name="fused_splade_pool", route="cuda",
             source="splade_tpu_torch/csrc/fused_splade_fwd.cu",
             replaces="splade_tpu/ops/fused_splade.py:50",
             launches=launches["fused_splade_pool"],
             **{k: pool_d[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
             max_abs_err_all=max(pool_q["max_abs_err"],
                                 pool_d["max_abs_err"]),
             shapes=[pool_d, pool_q]),
        dict(name="rescore_match", route="cuda",
             source="splade_tpu_torch/csrc/rescore.cu",
             replaces="splade_tpu/ops/rescore_kernel.py:54",
             also_replaces="splade_tpu/ops/rescore_kernel.py:127",
             launches=launches["rescore_match"],
             **{k: resc[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
             shapes=[resc]),
    ]
    log(json.dumps({"serving": serving, "batch_profiles": profiles,
                    "doc_encode_max_rel_diff": doc_encode_diff,
                    "peak_device_gb": peak_gb,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
