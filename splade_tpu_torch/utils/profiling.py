"""Profiling and tracing.

Counterpart of ``splade_tpu/utils/profiling.py``: ``trace`` captures a
``torch.profiler`` trace (host and, on a card, device activity) around any
code and writes it as a Chrome trace; ``StepTimer`` keeps per-step wall
clock with warm-up exclusion and percentiles; ``profile_fn`` warms a
function up, times ``steps`` calls under a trace and reports the device's
busy time, idle share and top kernels beside the wall clock. Timed CUDA
work is ended by ``torch.cuda.synchronize``, so a step's wall clock holds
its device work.

The reference's ``utils/runtime.py`` hooks (``force_cpu_if_requested``,
``setup_jax_cache``) drive JAX's runtime (``JAX_PLATFORMS``, libtpu, the
XLA compile cache) and have no counterpart here: the port's device rule is
``utils/runtime.py::resolve_device`` and its compile cache is the kernel
build under ``build/``.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def block_until_ready(out) -> Any:
    """Wait for the device work behind ``out`` (its first tensor) to end:
    a ``torch.cuda.synchronize`` of that tensor's card. CPU results are
    ready when returned."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Capture a torch.profiler trace of the block (CPU activity, and the
    card's when CUDA is available) and write it to ``log_dir/trace.json``
    (open it in chrome://tracing or Perfetto). Yields the profiler, whose
    ``events()`` the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Per-step wall-clock stats with warm-up exclusion and percentiles."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._n = 0

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self.times:
            return {"steps": 0}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1000),
            "p50_ms": float(np.percentile(arr, 50) * 1000),
            "p95_ms": float(np.percentile(arr, 95) * 1000),
            "max_ms": float(arr.max() * 1000),
        }


def device_spans(prof) -> list:
    """The card's (start_us, end_us, name) intervals of a finished
    profiler (kernels and copies), sorted by start."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def summarize_spans(spans, n_top: int = 8):
    """(busy microseconds, {name: ms} of the n_top largest) from device
    spans (start_us, end_us, name) sorted by start: busy is the union of
    the intervals; names are cut to 60 characters and kernels that then
    share a name (template instances of one kind) are added together."""
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return busy_us, {k: v / 1e3 for k, v in top}


def device_summary(prof, wall_ms: float, n_top: int = 8) -> Dict[str, Any]:
    """The card's side of a trace: busy ms, idle share of ``wall_ms``, the
    number of device ops and the ``n_top`` kernel names taking most time
    (``summarize_spans``). Busy and idle are None when the trace holds no
    device activity."""
    spans = device_spans(prof)
    if not spans:
        return dict(device_busy_ms=None, device_idle_share=None,
                    device_ops=0, top_kernels_ms={})
    busy_us, top = summarize_spans(spans, n_top)
    return dict(device_busy_ms=busy_us / 1e3,
                device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
                device_ops=len(spans), top_kernels_ms=top)


def profile_fn(fn: Callable, args: tuple, log_dir: str, steps: int = 3
               ) -> Dict[str, Any]:
    """Warm up, trace ``steps`` invocations, return timing stats: the
    StepTimer summary of the calls, and over the traced calls together the
    wall ms, the card's busy ms, idle share and top kernels
    (``device_summary``; None on the CPU). Writes ``step_times.json`` and
    ``trace.json`` under ``log_dir``."""
    block_until_ready(fn(*args))
    timer = StepTimer(warmup=0)
    with trace(log_dir) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with timer.step():
                block_until_ready(fn(*args))
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats: Dict[str, Any] = dict(timer.summary(), wall_ms=wall_ms)
    stats.update(device_summary(prof, wall_ms))
    (Path(log_dir) / "step_times.json").write_text(json.dumps(stats, indent=2))
    return stats
