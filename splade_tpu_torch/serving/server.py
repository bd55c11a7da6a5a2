"""HTTP search server (stdlib-only).

Counterpart of ``splade_tpu/serving/server.py``, with the same API
(JSON in/out):

    GET  /healthz            -> {"status": "ok", "docs": N}
    GET  /stats              -> batcher + engine statistics
    POST /search             -> {"query": str | "queries": [str], "k": int}
                                 => {"results": [[{"doc_id", "score"}, ...]]}
    POST /encode             -> {"texts": [str], "queries": bool}
                                 => {"vectors": [{token_id: weight}]}
    POST /index              -> {"docs": [{"id": str, "text": str}]}
                                 => {"added": N, "docs": total}
    POST /delete             -> {"ids": [str]} => {"deleted": N}

Requests are coalesced by DynamicBatcher, so concurrent clients share
device passes. ``--index`` takes ``dense`` and ``postings``; ``--device``
defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional, Tuple

from splade_tpu_torch.serving.batcher import DynamicBatcher
from splade_tpu_torch.serving.engine import ServingEngine

logger = logging.getLogger(__name__)


def _search_run_batch(engine: ServingEngine):
    """Batch fn over payloads [(query, k)]: one pass at max(k)."""

    def run(payloads: List[Tuple[str, int]]):
        kmax = max(max(k, 1) for _, k in payloads)
        ranked = engine.search_batch([q for q, _ in payloads], k=kmax)
        return [r[:max(k, 1)] for r, (_, k) in zip(ranked, payloads)]

    return run


class SearchService:
    """Engine + batcher wiring, independent of the HTTP layer."""

    def __init__(self, engine: ServingEngine, max_batch_size: int = 32,
                 max_wait_ms: float = 5.0, warmup: bool = False):
        self.engine = engine
        if warmup:
            engine.warmup(max_batch_size)
        self.batcher = DynamicBatcher(
            _search_run_batch(engine), max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, name="search-batcher")
        self._encode_lock = threading.Lock()

    def search(self, queries: List[str], k: int) -> List[List[dict]]:
        futs = [self.batcher.submit((q, k)) for q in queries]
        return [[{"doc_id": d, "score": s} for d, s in f.result(timeout=600)]
                for f in futs]

    def encode(self, texts: List[str], queries: bool) -> List[dict]:
        with self._encode_lock:  # one device encode stream
            vecs = self.engine.encode(texts, queries=queries)
        return [{int(i): float(v) for i, v in zip(idx, val)}
                for idx, val in vecs]

    def index_docs(self, docs: List[dict]) -> dict:
        with self._encode_lock:
            added = self.engine.add_documents(
                [(str(d["id"]), str(d["text"])) for d in docs])
        return {"added": added, "docs": self.engine.num_docs}

    def delete_docs(self, ids: List[str]) -> dict:
        return {"deleted": self.engine.delete_documents([str(i) for i in ids])}

    def stats(self) -> dict:
        return {"docs": self.engine.num_docs, **self.batcher.stats()}

    def close(self) -> None:
        self.batcher.close()


def make_handler(service: SearchService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: Any) -> None:
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # the request body was left unread (413): a keep-alive
                # client must not reuse the desynced stream
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "docs": service.engine.num_docs})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        MAX_BODY_BYTES = 64 << 20  # bound rfile.read: Content-Length is
        MAX_BATCH_ITEMS = 4096     # client-controlled; so is the list size

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > self.MAX_BODY_BYTES:
                    self.close_connection = True
                    return self._reply(413, {
                        "error": f"body {n} bytes exceeds "
                                 f"{self.MAX_BODY_BYTES} limit"})
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {"error": f"bad JSON: {e}"})
            for key in ("queries", "docs", "ids", "texts"):
                v = req.get(key)
                if isinstance(v, list) and len(v) > self.MAX_BATCH_ITEMS:
                    return self._reply(413, {
                        "error": f"'{key}' has {len(v)} items; limit "
                                 f"{self.MAX_BATCH_ITEMS} per request"})
            try:
                if self.path == "/search":
                    queries = req.get("queries")
                    if queries is None:
                        q = req.get("query")
                        if not isinstance(q, str) or not q:
                            return self._reply(
                                400, {"error": "need 'query' or 'queries'"})
                        queries = [q]
                    if not (isinstance(queries, list)
                            and all(isinstance(x, str) for x in queries)):
                        return self._reply(400, {"error": "'queries' must be [str]"})
                    k = req.get("k", 10)
                    if not isinstance(k, int) or isinstance(k, bool) or k < 1:
                        return self._reply(
                            400, {"error": "'k' must be a positive integer"})
                    self._reply(200, {"results": service.search(queries, k)})
                elif self.path == "/index":
                    docs = req.get("docs")
                    if not (isinstance(docs, list) and docs and all(
                            isinstance(d, dict) and "id" in d and "text" in d
                            for d in docs)):
                        return self._reply(
                            400, {"error": "'docs' must be [{id, text}, ...]"})
                    self._reply(200, service.index_docs(docs))
                elif self.path == "/delete":
                    ids = req.get("ids")
                    if not (isinstance(ids, list) and ids):
                        return self._reply(400,
                                           {"error": "'ids' must be [str]"})
                    self._reply(200, service.delete_docs(ids))
                elif self.path == "/encode":
                    texts = req.get("texts")
                    if not (isinstance(texts, list)
                            and all(isinstance(x, str) for x in texts)):
                        return self._reply(400, {"error": "'texts' must be [str]"})
                    self._reply(200, {"vectors": service.encode(
                        texts, bool(req.get("queries", False)))})
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except Exception as e:  # noqa: BLE001 — report, keep serving
                logger.exception("request failed")
                try:
                    self._reply(500, {"error": str(e)})
                except OSError:
                    logger.warning("client gone before error reply")

    return Handler


class _Server(ThreadingHTTPServer):
    # the stdlib listen backlog of 5 resets bursts of concurrent connects
    request_queue_size = 128
    daemon_threads = True


def create_server(service: SearchService, host: str = "127.0.0.1",
                  port: int = 0) -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(service))


def _cache_overrides(args, index) -> List[str]:
    """CLI shape flags that the loaded --index-cache overrides."""
    pairs = (("--n-postings", args.n_postings, index.n_postings),
             ("--rescore", args.rescore or None, index.rescore_candidates),
             ("--query-top-k", args.query_top_k, index.query_top_t))
    return [f"{flag} {given} (cache: {kept})" for flag, given, kept in pairs
            if given is not None and given != kept]


# ----------------------------------------------------------------- CLI
def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser("splade-tpu-torch serving daemon")
    p.add_argument("--checkpoint", required=True,
                   help="HF export dir (config.json + weights)")
    p.add_argument("--docs", default=None,
                   help="JSONL corpus: {\"id\": ..., \"text\"|\"contents\": ...}"
                        " (optional when --index-cache exists)")
    p.add_argument("--index-cache", default=None,
                   help="persisted postings index: load it if present, "
                        "else encode + build + save")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    p.add_argument("--int8", action="store_true", default=True)
    p.add_argument("--no-int8", dest="int8", action="store_false")
    p.add_argument("--index", default=None, choices=["dense", "postings"],
                   help="dense [N,V] matrix (<~300K docs) or truncated "
                        "postings. Default: dense, or postings with "
                        "--index-cache")
    p.add_argument("--n-postings", type=int, default=None,
                   help="postings: per-term list cap (default 2048)")
    p.add_argument("--rescore", type=int, default=0,
                   help=">0 with --index postings: two-phase search, this "
                        "many candidates re-scored exactly")
    p.add_argument("--posting-scoring", default="auto",
                   choices=("auto", "scatter", "sort", "select",
                            "select_sum"),
                   help="postings phase-1 aggregation (select/select_sum "
                        "need --rescore > 0). Applies to fresh builds AND "
                        "as a load-time override on an --index-cache")
    p.add_argument("--query-top-k", type=int, default=64)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   default=True, help="skip the warm-up passes")
    args = p.parse_args(argv)

    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.serving.engine import build_engine_from_docs
    from splade_tpu_torch.utils.runtime import resolve_device
    from splade_tpu_torch.utils.tokenizer import create_tokenizer

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    device = resolve_device(args.device)
    tokenizer = create_tokenizer(args.tokenizer or args.checkpoint)
    enc = SparseEncoderV33.from_any(args.checkpoint, tokenizer, device=device)

    cache_hit = args.index_cache and os.path.exists(args.index_cache)
    # --index-cache implies postings even on the first run: the dense index
    # has no save(), so its cache would never be written
    index_kind = args.index or ("postings" if args.index_cache else "dense")
    if args.index_cache and index_kind == "dense":
        p.error("--index dense cannot be persisted; use --index postings "
                "with --index-cache")
    if cache_hit:
        logger.info("loading persisted postings index %s ...",
                    args.index_cache)
        overrides = {"device": device}
        if args.posting_scoring != "auto":
            overrides["scoring"] = args.posting_scoring
        index = PostingsIndex.load(args.index_cache, **overrides)
        ignored = _cache_overrides(args, index)
        logger.warning(
            "persisted index config wins (%s); delete the cache to "
            "re-shape. Loaded: %s",
            "CLI flags overridden by the cache: " + ", ".join(ignored)
            if ignored else "no CLI shape flag differs from it",
            index.config_summary())
        engine = ServingEngine(enc.model, tokenizer, index,
                               query_top_k=args.query_top_k, device=device)
    else:
        if not args.docs:
            p.error("--docs is required when --index-cache is absent")
        docs = []
        with open(args.docs, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                docs.append((str(d.get("id", len(docs))),
                             d.get("text") or d.get("contents") or ""))
        logger.info("indexing %d docs ...", len(docs))
        engine = build_engine_from_docs(
            enc.model, tokenizer, docs, int8=args.int8,
            query_top_k=args.query_top_k, index_type=index_kind,
            n_postings=args.n_postings, rescore_candidates=args.rescore,
            posting_scoring=args.posting_scoring, device=device)
        if args.index_cache:
            engine.index.save(args.index_cache)
    service = SearchService(engine, max_batch_size=args.max_batch_size,
                            max_wait_ms=args.max_wait_ms, warmup=args.warmup)
    httpd = create_server(service, args.host, args.port)
    logger.info("serving %d docs on http://%s:%d", engine.num_docs,
                *httpd.server_address[:2])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        service.close()
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
