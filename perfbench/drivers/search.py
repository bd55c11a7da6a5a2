"""Open-loop search: single-query requests at a fixed Poisson rate into the
port's ``SearchService``, over a postings index of a synthetic corpus.

Set-up makes the corpus (``texts.zipf_corpus_csr``), builds the traffic's
index class with the corpus added by ``add_csr``, a ``ServingEngine`` over a
``SpladeEncoder`` holding the benchmark's weights in bfloat16, and a
``SearchService`` that warms the engine's batch buckets and k tiers. In the
window the calling thread sleeps to each request's due time and submits
``(query, k)`` to the service's ``DynamicBatcher`` without waiting, as
``SearchService.search`` submits; a callback stamps each answer. A request's latency runs from its due time to
its answer; one that fails, or has no answer a minute after the window,
counts as failed, with that minute as its latency. Then a sample of the
answered requests, drawn from the seed, is held against the reference.
"""

from __future__ import annotations

import gc
import importlib
import math
import os
import time
from typing import List

import numpy as np
import torch

from perfbench.core import texts
from perfbench.core.bench import (Outcome, free_cache, log, now,
                                  peak_bytes, sync)
from perfbench.core.compare import checks, search_readings
from perfbench.core.trace import Tracer
from perfbench.core.weights import make_weights
from perfbench.drivers.common import ScopedCalls, model_config

WAIT_AFTER_S = 60.0


def arrivals(seed: int, rate: float, seconds: float, k_mix: dict):
    """(due times [n], ks [n]): n = rate x seconds requests whose gaps and
    ks are one multiset for every seed, in the seed's order."""
    n = max(int(round(rate * seconds)), 1)
    fixed = np.random.default_rng([texts.FIXED_SIZES, 9])
    gaps = fixed.exponential(1.0 / rate, n)
    ks = np.concatenate([np.full(int(round(share * n)), int(k))
                         for k, share in sorted(k_mix.items())])
    ks = np.resize(ks, n)
    rng = texts.rng_for(seed, 5)
    gaps, ks = rng.permutation(gaps), rng.permutation(ks)
    due = np.cumsum(gaps)
    return due * (seconds / (due[-1] + gaps.mean())), ks


class Served:
    """The program's search stack over the cell's corpus."""

    def __init__(self, cell, seed: int, device: str):
        from splade_tpu_torch.models.splade import SpladeEncoder
        from splade_tpu_torch.serving.engine import ServingEngine
        from splade_tpu_torch.serving.server import SearchService

        tr, cfg = cell.traffic, cell.config
        serve = cfg["serve"]
        self.tok = texts.CharTokenizer(cfg["vocab_size"])
        corpus = tr["corpus"]
        self.terms, self.vals = texts.zipf_corpus_csr(
            seed, corpus["documents"], cfg["vocab_size"],
            corpus["terms_per_document"], corpus["zipf_exponent"])
        t0 = now()
        spec = tr["index"]
        cls = getattr(importlib.import_module(spec["module"]), spec["class"])
        self.index = cls(cfg["vocab_size"], device=device, **spec["kwargs"])
        self.index.add_csr([f"d{i}" for i in range(len(self.terms))],
                           self.terms, self.vals)
        self.index.build()
        self.build_s = now() - t0
        dtype = getattr(torch, serve["dtype"])
        weights = make_weights(cfg, seed, device, dtype,
                               serve["decoder_bias"])
        model = SpladeEncoder(model_config(cell, "serve"), pool_impl="kernel",
                              device=device)
        model.mlm.load_state_dict(weights)
        del weights
        self.model = model.to(dtype).eval()
        self.engine = ServingEngine(
            self.model, self.tok, self.index,
            query_max_length=serve["query_max_length"],
            query_top_k=serve["query_top_k"], device=device)
        b = tr["batcher"]
        self.service = SearchService(
            self.engine, max_batch_size=b["max_batch_size"],
            max_wait_ms=b["max_wait_ms"], warmup=True)

    def close(self) -> None:
        self.service.close()


class EngineSpans:
    """While tracing, each ``search_batch`` call of the engine instance:
    (start, end, queries)."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []
        self.inner = engine.search_batch

        def wrapped(queries, k=10):
            t0 = now()
            out = self.inner(queries, k)
            self.calls.append((t0, now(), list(queries)))
            return out

        engine.search_batch = wrapped

    def close(self) -> None:
        self.engine.search_batch = self.inner


def open_loop(service, queries: List[str], due: np.ndarray, ks: np.ndarray,
              t0: float, at_time=()):
    """Submit each request at its due time; returns (futures, answer
    times, lateness of each submission). ``at_time``: (seconds into the
    window, fn) pairs, each fn called once, before the first request due
    after it (the profiler starts and stops on the thread that runs it)."""
    n = len(queries)
    pending = sorted(at_time, key=lambda x: x[0])
    done = [math.nan] * n
    futures, late = [], np.zeros(n)

    def stamp(i):
        def cb(_fut):
            done[i] = now()
        return cb

    for i in range(n):
        at = t0 + due[i]
        while pending and pending[0][0] <= due[i]:
            pending.pop(0)[1]()
        left = at - now()
        if left > 0:  # one wake-up a request: no polling for the GIL
            time.sleep(left)
        late[i] = now() - at
        fut = service.batcher.submit((queries[i], int(ks[i])))
        fut.add_done_callback(stamp(i))
        futures.append(fut)
    for _, fn in pending:
        fn()
    return futures, done, late


class Pauses:
    """The interpreter's garbage collections during the window: count and
    seconds by generation (a whole-process pause that every request in
    flight waits through)."""

    def __init__(self):
        self.by_gen: dict = {}
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = now()
        else:
            n, total, most = self.by_gen.get(info["generation"], (0, 0.0, 0.0))
            dt = now() - self._t0
            self.by_gen[info["generation"]] = (n + 1, total + dt,
                                               max(most, dt))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)

    def text(self) -> str:
        return "; ".join(f"gen {g}: {n} in {t * 1e3:.1f} ms, longest "
                         f"{m * 1e3:.1f} ms" for g, (n, t, m)
                         in sorted(self.by_gen.items()))


def window(served: Served, seed: int, rate: float, seconds: float,
           queries: List[str], k_mix: dict, tracer=None, calls=None,
           traced=(0.0, 0.0)):
    due, ks = arrivals(seed, rate, seconds, k_mix)
    queries = queries[:len(due)]
    at_time = []
    if tracer is not None:
        def start():
            tracer.start()
            calls.active = True

        def stop():
            calls.active = False
            tracer.stop()

        at_time = [(traced[0], start), (traced[1], stop)]
    # a full collection ends the set-up, so the window's collections come
    # at the same points of the same work in every run (PERF.md)
    gc.collect()
    sync()
    t0 = now()
    with Pauses() as pauses:
        futures, done, late = open_loop(served.service, queries, due, ks, t0,
                                        at_time)
    deadline = t0 + seconds + WAIT_AFTER_S
    answers, failed = [], 0
    for i, fut in enumerate(futures):
        try:
            answers.append(fut.result(timeout=max(deadline - now(), 0.0)))
        except Exception:  # noqa: BLE001 - a failed request is counted
            answers.append(None)
            failed += 1
    lat = np.array([(d - (t0 + u)) if a is not None and d == d
                    else WAIT_AFTER_S + seconds - u
                    for d, u, a in zip(done, due, answers)])
    return dict(t0=t0, due=due, ks=ks, queries=queries, answers=answers,
                latency_s=lat, late_s=late, failed=failed,
                pauses=pauses.text())


def percentile(values: np.ndarray, q: float) -> float:
    """Nearest rank: the smallest value with at least q of all at or
    below it."""
    v = np.sort(values)
    return float(v[max(int(math.ceil(q * len(v))) - 1, 0)])


def pin_threads() -> list:
    """Every thread of the process onto the first half of its CPUs (new
    threads inherit it). The served path is host-bound Python: unpinned,
    its latencies spread by a third from run to run on an 8-core card
    machine, pinned by under a tenth (PERF.md)."""
    cpus = sorted(os.sched_getaffinity(0))
    keep = set(cpus[:max(1, len(cpus) // 2)])
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), keep)
        except OSError:  # a thread that ended meanwhile
            pass
    return sorted(keep)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        tmp: str, t_start: float) -> Outcome:
    tr = cell.traffic
    log(f"threads pinned to CPUs {pin_threads()}")
    served = Served(cell, seed, device)
    rate = tr["rate_per_s"]
    queries = texts.queries(seed, int(round(rate * seconds)) + 1,
                            tuple(tr["query_words"]))
    log(f"corpus {len(served.terms)} documents, index built in "
        f"{served.build_s:.1f} s")
    setup_s = now() - t_start
    tracer, calls, spans = None, None, None
    traced = (min(2.0, 0.2 * seconds), min(2.0, 0.2 * seconds)
              + min(tr.get("traced_s", 3.0), 0.6 * seconds))
    if trace:
        tracer, calls = Tracer(tmp), ScopedCalls(True)
        tracer.warm()
        spans = EngineSpans(served.engine)
        calls.__enter__()
    try:
        w = window(served, seed, rate, seconds, queries, tr["k_mix"], tracer,
                   calls, traced)
    finally:
        if trace:
            calls.__exit__(None, None, None)
            spans.close()
    peak = peak_bytes()
    stats = served.service.batcher.stats()
    lat_ms = w["latency_s"] * 1e3
    n = len(lat_ms)
    log(f"requests sent {n}, answered {n - w['failed']}, failed "
        f"{w['failed']}; generator late p50 {np.median(w['late_s']) * 1e3:.3f}"
        f" ms, max {w['late_s'].max() * 1e3:.3f} ms; batcher {stats}; "
        f"garbage collections in the window: {w['pauses'] or 'none'}")
    context = {"kind": "search", "model": cell.config, "rate": rate,
               "window": w, "spans": spans.calls if spans else [],
               "records": calls.records if calls else {},
               "traced": (w["t0"] + traced[0], w["t0"] + traced[1]),
               "tok": served.tok,
               "query_max_length": cell.config["serve"]["query_max_length"]}
    trace_out = tracer.read() if tracer is not None else None
    sample = check_sample(seed, w, tr["check_requests"])
    served_docs = [[(int(d[1:]), float(s)) for d, s in w["answers"][i]]
                   for i in sample]
    terms, vals = served.terms, served.vals
    served.close()
    del served
    free_cache()
    readings = reference_readings(cell, seed, terms, vals,
                                  [w["queries"][i] for i in sample],
                                  [int(w["ks"][i]) for i in sample],
                                  served_docs, device)
    readings["failed_requests"] = w["failed"]
    log(f"gaps of the checked requests, p50 / p90 / max: "
        f"{readings['_p50_p90_max']}")
    return Outcome(
        metrics={"search_p95_ms": percentile(lat_ms, 0.95),
                 "search_p50_ms": percentile(lat_ms, 0.50),
                 "setup_s": setup_s},
        attempted=n, failed=w["failed"],
        checks=checks(readings, tr["limits"]),
        memory_peak_bytes=peak, context=context, trace=trace_out)


def check_sample(seed: int, w: dict, n: int) -> List[int]:
    """Answered requests drawn from the seed, the longest (the largest k)
    among them."""
    answered = [i for i, a in enumerate(w["answers"]) if a is not None]
    rng = texts.rng_for(seed, 6)
    pick = rng.choice(len(answered), min(n, len(answered)), replace=False)
    longest = max(answered, key=lambda i: w["ks"][i], default=None)
    out = sorted({answered[i] for i in pick})
    if longest is not None and longest not in out:
        out.append(longest)
    return out


def reference_readings(cell, seed, terms, vals, queries, ks, served_docs,
                       device, mm_name: str = "f32") -> dict:
    from perfbench.reference import precision
    from perfbench.reference.search import (Corpus, exact_of, query_vectors,
                                            search)

    precision.tf32_off()
    tr, cfg = cell.traffic, cell.config
    spec = tr["index"]["kwargs"]
    corpus = Corpus(terms, vals, cfg["vocab_size"], spec["n_postings"],
                    device)
    weights = make_weights(cfg, seed, device,
                           getattr(torch, cfg["serve"]["dtype"]),
                           cfg["serve"]["decoder_bias"])
    p = {n: w.float() for n, w in weights.items()}
    del weights
    tok = texts.CharTokenizer(cfg["vocab_size"])
    rep = query_vectors(p, cfg, tok, queries,
                        cfg["serve"]["query_max_length"],
                        tok.all_special_ids, device,
                        precision.PRODUCTS[mm_name])
    ranked, dense = search(corpus, rep, ks, spec["query_top_t"],
                           spec["rescore_candidates"])
    exact = exact_of(corpus, dense, [[d for d, _ in s] for s in served_docs])
    return search_readings(served_docs, exact,
                           [[s for _, s in r] for r in ranked])
