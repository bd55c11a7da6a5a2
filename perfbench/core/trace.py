"""The device trace of a traced run and what the metric readers take from it.

A ``Tracer`` runs ``torch.profiler`` (host and CUDA activity) over part of
the measured window, writes the Chrome trace into the run's temporary
directory, reads it back and deletes it. From it:

- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``window_s``: the traced window by the host clock, a synchronize at each
  end;
- ``device_ops``: seconds by device operation name;
- ``idle_gaps``: the device's idle time between operations, by the
  innermost host operation that covered the gap's middle on the thread
  that launched the next device operation;
- ``scope_s``: device seconds of the kernels launched inside each named
  host scope. A scope is either a ``record_function`` range that the
  benchmark opens around a call into the program (``SCOPE_PREFIX`` + op)
  or an autograd node whose name matches (``BACKWARD_NODES``). A kernel
  belongs to a scope when the runtime call that launched it lies inside the
  scope's host interval on the same thread; ``scope_n`` counts each
  scope's calls.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.core.bench import sync

SCOPE_PREFIX = "perfbench."
#: scope -> substring of the autograd node that runs its backward
BACKWARD_NODES = {"pool_bwd": "_FusedPoolBackward",
                  "splash_bwd": "_SplashAttentionBackward"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def scope(op: str):
    """A host scope the trace attributes kernels to (no cost untraced
    beyond ``record_function``'s own)."""
    with torch.profiler.record_function(SCOPE_PREFIX + op):
        yield


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    scope_s: Dict[str, float] = field(default_factory=dict)
    scope_n: Dict[str, int] = field(default_factory=dict)
    kernels: List[Tuple[str, float]] = field(default_factory=list)

    def breakdown(self) -> dict:
        return {"device_ops": [list(x) for x in self.device_ops[:10]],
                "idle_gaps": [list(x) for x in self.idle_gaps[:10]]}


class Tracer:
    """start() ... stop() inside the window, read() -> Trace after it.
    ``tmpdir`` holds the trace file while it is read."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self._prof = None
        self._done = None
        self._trace: Optional[Trace] = None
        self._t0 = 0.0
        self.window_s = 0.0

    @staticmethod
    def _profile():
        """A profiler of host and device activity on every thread (the
        program's batcher launches from a thread of its own)."""
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:
            from torch.profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA], **kw)

    def warm(self) -> None:
        """Start and stop the profiler once outside the window: its first
        start initialises the device tracing, which takes seconds."""
        device = "cuda" if torch.cuda.is_available() else "cpu"
        with self._profile():
            torch.ones(1, device=device).sum()
            sync()

    def start(self) -> None:
        sync()
        self._prof = self._profile()
        self._prof.start()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def stop(self) -> None:
        sync()
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self._done, self._prof = self._prof, None

    def read(self) -> Optional[Trace]:
        """The stopped trace, read once the window has closed (None if the
        tracer never ran)."""
        if self._done is None:
            return None
        if self._trace is None:
            path = os.path.join(self.tmpdir, "trace.json")
            self._done.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(path)
            self._trace = read_trace(events, self.window_s)
        return self._trace


def _union(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    busy, merged = 0.0, []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                busy += e - merged[-1][1]
                merged[-1][1] = e
        else:
            merged.append([s, e])
            busy += e - s
    return busy, merged


class _Ranges:
    """Host intervals of one thread, sorted by start."""

    def __init__(self):
        self.items: List[Tuple[float, float, str]] = []

    def add(self, start, end, name):
        self.items.append((start, end, name))

    def freeze(self):
        self.items.sort()
        self.starts = [s for s, _, _ in self.items]
        self.longest = max((e - s for s, e, _ in self.items), default=0.0)

    def containing(self, t: float) -> List[Tuple[float, float, str]]:
        """Every interval that holds t, innermost first: scanning back by
        start, no interval that starts before t - longest can hold it."""
        out = []
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][0] >= t - self.longest:
            if self.items[i][1] >= t:
                out.append(self.items[i])
            i -= 1
        return out

    def innermost(self, t: float, limit: int = 4096):
        """The latest-starting interval that holds t; host ops on one
        thread nest, so that is the innermost. None past ``limit``
        intervals."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and limit:
            if self.items[i][1] >= t:
                return self.items[i]
            i, limit = i - 1, limit - 1
        return None


def _scope_of(name: str) -> Optional[str]:
    if name.startswith(SCOPE_PREFIX):
        return name[len(SCOPE_PREFIX):]
    for op, node in BACKWARD_NODES.items():
        if node in name:
            return op
    return None


def read_trace(events: list, window_s: float) -> Trace:
    device, launches = [], {}
    host: Dict[object, _Ranges] = defaultdict(_Ranges)
    scopes: Dict[object, _Ranges] = defaultdict(_Ranges)
    for ev in events:
        cat, ph = ev.get("cat"), ev.get("ph")
        if ph != "X":
            continue
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((float(ev["ts"]), float(ev.get("dur", 0.0)),
                           ev.get("name", "?"), args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = (ev["tid"], float(ev["ts"]))
        elif cat in HOST_CATS:
            ts, name = float(ev["ts"]), ev.get("name", "?")
            end = ts + float(ev.get("dur", 0.0))
            host[ev["tid"]].add(ts, end, name)
            op = _scope_of(name)
            if op is not None:
                scopes[ev["tid"]].add(ts, end, op)
    for r in (*host.values(), *scopes.values()):
        r.freeze()
    # scope calls: the outermost interval of each op on each thread (an
    # autograd node shows as an engine event with the node's call inside)
    scope_n: Dict[str, int] = defaultdict(int)
    for r in scopes.values():
        ends: Dict[str, float] = {}
        for start, end, op in r.items:
            if start >= ends.get(op, float("-inf")):
                scope_n[op] += 1
                ends[op] = end
    busy_us, merged = _union((ts, ts + dur) for ts, dur, _, _ in device)
    by_name: Dict[str, float] = defaultdict(float)
    scope_s: Dict[str, float] = defaultdict(float)
    kernels: Dict[str, float] = defaultdict(float)
    for ts, dur, name, corr in device:
        by_name[name] += dur / 1e6
        if not name.startswith("Memcpy") and not name.startswith("Memset"):
            kernels[name] += dur / 1e6
        launch = launches.get(corr)
        if launch is None:
            continue
        tid, t = launch
        if tid not in scopes:
            continue
        for op in {op for _, _, op in scopes[tid].containing(t)}:
            scope_s[op] += dur / 1e6
    # idle gaps, named by the host op that covered the gap's middle on the
    # thread that launched the device op ending the gap
    starts = sorted(device)
    gaps: Dict[str, float] = defaultdict(float)
    j = 0
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        while j < len(starts) and starts[j][0] < s1:
            j += 1
        corr = starts[j][3] if j < len(starts) else None
        label = "host outside any traced op"
        launch = launches.get(corr)
        if launch is not None and launch[0] in host:
            covering = host[launch[0]].innermost((e0 + s1) / 2)
            if covering is not None:
                label = covering[2]
        gaps[label] += gap / 1e6
    return Trace(
        window_s=window_s, busy_s=busy_us / 1e6,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
        scope_s=dict(scope_s), scope_n=dict(scope_n),
        kernels=sorted(kernels.items(), key=lambda kv: -kv[1]))
