"""The port's profiling (splade_tpu_torch.utils.profiling) beside
tests/test_profiling.py: the step timer's warm-up exclusion and stats on
both packages, profile_fn's trace and step-time files on the CPU, and the
device summary's arithmetic (busy = the union of device intervals) on a
stand-in trace."""

import json
from types import SimpleNamespace

import pytest
import torch

from splade_tpu.utils.profiling import StepTimer as JaxStepTimer
from splade_tpu_torch.utils import profiling
from splade_tpu_torch.utils.profiling import (StepTimer, block_until_ready,
                                              device_summary, profile_fn,
                                              trace)


@pytest.mark.parametrize("cls", [StepTimer, JaxStepTimer],
                         ids=["port", "jax"])
def test_step_timer_warmup_and_stats(cls):
    t = cls(warmup=2)
    for _ in range(7):
        with t.step():
            pass
    s = t.summary()
    assert s["steps"] == 5
    assert set(s) == {"steps", "mean_ms", "p50_ms", "p95_ms", "max_ms"}
    assert s["p50_ms"] >= 0 and s["max_ms"] >= s["p50_ms"]
    assert cls().summary() == {"steps": 0}


def test_profile_fn_writes_trace_and_stats(tmp_path):
    x = torch.ones(64, 64)
    calls = []

    def f(a):
        calls.append(1)
        return (a @ a).sum()

    stats = profile_fn(f, (x,), str(tmp_path / "trace"), steps=2)
    assert len(calls) == 3  # one warm-up, two traced
    assert stats["steps"] == 2 and stats["wall_ms"] > 0
    saved = json.loads((tmp_path / "trace" / "step_times.json").read_text())
    assert saved["mean_ms"] > 0 and saved["steps"] == 2
    # the CPU run has no device activity: busy and idle are not measured
    assert saved["device_busy_ms"] is None and saved["device_ops"] == 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])


def test_trace_writes_on_an_exception(tmp_path):
    with pytest.raises(RuntimeError):
        with trace(str(tmp_path / "t")):
            torch.ones(3).sum()
            raise RuntimeError("inside the block")
    assert (tmp_path / "t" / "trace.json").exists()


def test_block_until_ready_synchronizes_only_cuda_results(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    out = {"a": [1, (torch.ones(2),)]}
    assert block_until_ready(out) is out
    assert synced == []

    class CudaLike:
        is_cuda = True
        device = "cuda:0"

    monkeypatch.setattr(profiling, "_first_tensor", lambda out: CudaLike())
    block_until_ready(object())
    assert synced == ["cuda:0"]


def test_device_summary_counts_the_union_of_device_intervals():
    from torch.autograd import DeviceType

    def ev(start, end, name, dev=DeviceType.CUDA):
        return SimpleNamespace(time_range=SimpleNamespace(start=start,
                                                          end=end),
                               name=name, device_type=dev)

    prof = SimpleNamespace(events=lambda: [
        ev(0, 100, "k1"), ev(50, 150, "k2"), ev(300, 400, "k1"),
        ev(0, 1000, "host op", DeviceType.CPU)])
    got = device_summary(prof, wall_ms=1.0)
    assert got["device_busy_ms"] == pytest.approx(0.25)
    assert got["device_idle_share"] == pytest.approx(0.75)
    assert got["device_ops"] == 3
    assert got["top_kernels_ms"] == {"k1": pytest.approx(0.2),
                                     "k2": pytest.approx(0.1)}
