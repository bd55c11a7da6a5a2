"""Dynamic micro-batching for serving.

Counterpart (a copy) of ``splade_tpu/serving/batcher.py``. Concurrent
requests are coalesced into one device dispatch: the worker blocks on the
first request, then drains the queue for up to ``max_wait_ms`` or
``max_batch_size`` items, so the card sees wide batches instead of B=1
calls and per-request dispatch overhead divides by the batch size.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Sequence

logger = logging.getLogger(__name__)


class DynamicBatcher:
    """Coalesces submit() payloads into run_batch(list) calls.

    run_batch receives the payload list and must return one result per
    payload (same order). A run_batch exception fails every future in that
    batch; the worker keeps serving.
    """

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Sequence[Any]],
        max_batch_size: int = 32,
        max_wait_ms: float = 5.0,
        name: str = "batcher",
    ):
        self._run_batch = run_batch
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self.n_batches = 0
        self.n_items = 0
        self._latencies: List[float] = []  # rolling window, seconds
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, name=name, daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- API
    def submit(self, payload: Any) -> Future:
        # The closed-check and enqueue are one atomic section vs close():
        # otherwise a payload can land behind the shutdown sentinel on a
        # dead queue and its future would never resolve.
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            fut: Future = Future()
            self._q.put((payload, fut, time.perf_counter()))
        return fut

    def __call__(self, payload: Any, timeout: float = 60.0) -> Any:
        return self.submit(payload).result(timeout=timeout)

    def close(self) -> None:
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=5)

    def stats(self) -> dict:
        with self._lock:
            # counters update under the same lock in the worker — reading
            # them outside could pair items from N batches with N+1
            lat = sorted(self._latencies)
            n_batches, n_items = self.n_batches, self.n_items
        out = {
            "batches": n_batches,
            "items": n_items,
            "mean_batch_size": (n_items / n_batches if n_batches else 0.0),
        }
        if lat:
            pick = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)] * 1e3
            out.update(latency_p50_ms=pick(0.50), latency_p95_ms=pick(0.95),
                       latency_p99_ms=pick(0.99))
        return out

    # -------------------------------------------------------------- worker
    def _drain(self, first) -> List[Any]:
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch_size:
            remaining = deadline - time.perf_counter()
            try:
                item = self._q.get(timeout=max(remaining, 0.0))
            except queue.Empty:
                break
            if item is None:          # close sentinel: put it back and stop
                self._q.put(None)
                break
            batch.append(item)
        return batch

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                # fail anything still queued behind the sentinel
                while True:
                    try:
                        p, fut, _ = self._q.get_nowait()
                        fut.set_exception(RuntimeError("batcher closed"))
                    except queue.Empty:
                        return
                    except (TypeError, ValueError):
                        return
            batch = self._drain(item)
            payloads = [p for p, _, _ in batch]
            try:
                results = self._run_batch(payloads)
                if len(results) != len(payloads):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(payloads)} payloads")
            except Exception as e:  # noqa: BLE001 — fail the batch, keep serving
                for _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)
                logger.exception("batch of %d failed", len(batch))
                continue
            now = time.perf_counter()
            with self._lock:
                self.n_batches += 1
                self.n_items += len(batch)
                for _, _, t0 in batch:
                    self._latencies.append(now - t0)
                if len(self._latencies) > 2048:
                    del self._latencies[:-1024]
            for (_, fut, _), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
