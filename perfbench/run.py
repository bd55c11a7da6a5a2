"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names its configuration and
its traffic mix; the traffic names its driver (``perfbench/drivers``). The
run makes its inputs and weights from the seed, sets up and warms the
program, measures for ``--seconds``, then holds what the timed path
produced against the plain reference (``perfbench/reference``). Its last
line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, traced, ``breakdown``; last comes
``checks``, each number compared with its limit, which also close standard
error. Everything else goes to standard error. With no card, with fewer
cards than the cell asks, or with JAX or the JAX package loaded when the
window has closed, it prints no result and exits with 2, 2 or 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import bench  # noqa: E402


def result_line(cell, out, trace: bool, torch, root=bench.ROOT) -> dict:
    """The result object: end-to-end metrics untraced, per-layer traced
    (each read by its own file; a reader that finds nothing is left
    out)."""
    metrics = {}
    if trace:
        ctx = dict(out.context, trace=out.trace)
        for m in cell.per_layer:
            value = bench.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": bench.device_desc(torch, cell.chips,
                                        out.memory_peak_bytes,
                                        out.trace if trace else None)}
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = out.checks
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             root=bench.ROOT, t_start: float = T_START):
    """Set up, measure and check one run of ``cell``: the driver's
    Outcome. ``device`` is "cuda" from the command line; the tests pass
    "cpu" to drive the rest of a run at a tiny size."""
    drv = bench.driver(cell, root)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        with bench.SmiSampler() if device == "cuda" else _Nothing() as smi:
            out = drv.run(cell, seed, seconds, trace, device, tmp, t_start)
        for sample in getattr(smi, "samples", []):
            bench.log("nvidia-smi clocks.sm, clocks.mem, power.draw, "
                      "power.limit, temperature: " + sample)
    return out


class _Nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    cell = bench.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        bench.log("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        bench.log(f"{args.workload} needs {cell.chips} cards, this machine "
                  f"has {torch.cuda.device_count()}")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = bench.forbidden_loaded()
    if found:
        bench.log(f"modules loaded that the run may not load: {found}")
        return 3
    line = result_line(cell, out, bool(args.trace), torch)
    for name, c in out.checks.items():
        bench.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
