"""What every run shares: finding a cell's files by name, the run's
environment, the card's description, the guards, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``), a
traffic mix (``perfbench/traffic/<traffic>.json``, whose ``driver`` names
``perfbench/drivers/<driver>.py``) and, through the metric entries, the
per-layer readers (``perfbench/metrics/<name>.py``). Adding any of these
takes new files and a new entry, and no edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
#: top-level module names that may not be loaded when a run ends
FORBIDDEN = ("jax", "jaxlib", "flax", "splade_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_name: str
    traffic: dict
    traffic_name: str
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(has {sorted(work)})")
    w = work[name]
    return files_cell(name, w["config"], w["traffic"], w["chips"], root,
                      bench)


def files_cell(name: str, config: str, traffic: str, chips: int = 1,
               root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """A cell of a configuration and a traffic mix by their names, with
    the metrics BENCHMARK.json gives it (none when it is not an entry
    there: the sweep and the controls run mixes kept for later cells)."""
    bench = bench or load_benchmark(root)
    cfg = {c["name"]: c for c in bench["configs"]}[config]
    return Cell(name=name, chips=chips,
                config=json.loads((root / cfg["file"]).read_text()),
                config_name=config,
                traffic=json.loads((root / "perfbench" / "traffic"
                                    / f"{traffic}.json").read_text()),
                traffic_name=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _for_cell(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _for_cell(m, name)])


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell, root: Path = ROOT):
    return _load_file(root / "perfbench" / "drivers"
                      / f"{cell.traffic['driver']}.py",
                      f"perfbench_driver_{cell.traffic['driver']}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(ctx) -> float | None`` of ``perfbench/metrics/<name>.py``."""
    return _load_file(root / "perfbench" / "metrics" / f"{name}.py",
                      "perfbench_metric_" + name.replace(".", "_")).read


def set_cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's nvcc library is already under ``build/splade_tpu_torch``),
    and no library loading JAX on its own."""
    build = root / "build" / "perfbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def smi(query: str) -> List[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


class SmiSampler:
    """nvidia-smi's clocks and power read when the run starts and when its
    window and check are over: beside the window, not during it (a
    process started every second competes with a host-bound server)."""

    QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"

    def __init__(self):
        self.samples: List[str] = []

    def __enter__(self):
        self.samples += smi(self.QUERY)[:1]
        return self

    def __exit__(self, *exc):
        self.samples += smi(self.QUERY)[:1]


@dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, the count of work
    attempted and failed, the comparison's numbers with their limits, the
    per-layer context and the device trace."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, dict]
    memory_peak_bytes: int
    context: dict = field(default_factory=dict)
    trace: Optional[object] = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] is not None and c["value"] <= c["limit"]
            for c in self.checks.values())


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_desc(torch, chips: int, peak: int, trace=None) -> dict:
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": chips, "memory_peak_bytes": int(peak)}
    limits = smi("power.limit")
    if limits:
        d["power_limit"] = limits[0]
    if trace is not None:
        d["busy_s"] = trace.busy_s
        d["window_s"] = trace.window_s
    return d


def now() -> float:
    return time.perf_counter()


def sync() -> None:
    """Wait for the card (nothing to wait for on a CPU run)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_bytes() -> int:
    import torch

    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0


def free_cache() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
