"""Find the highest rate a search cell sustains: one set-up, then a
window at each rate, on the card.

    python3 perfbench/sweep.py \
        --workload ax-encoder-base-splade:postings_1m5_poisson \
        --seed 5 --seconds 30 --rates 150 200 250 300 --limit-ms 100

For each rate it prints p50 and p95 latency from the due time, the share of
requests over the latency limit, the mean batch, and whether the backlog
grew (the last fifth of the requests waited more than twice as long as the
first fifth, and over the limit). The cell's rate (its traffic file) is
four fifths of the highest rate whose p95 meets the limit with no growing
backlog; the benchmark's runs do not sweep.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import bench, texts  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json, or config:traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--limit-ms", type=float, required=True)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    cell = (bench.files_cell(args.workload, *args.workload.split(":"))
            if ":" in args.workload else bench.load_cell(args.workload))
    drv = bench.driver(cell)
    served = drv.Served(cell, args.seed, "cuda")
    tr = cell.traffic
    for rate in args.rates:
        queries = texts.queries(args.seed, int(round(rate * args.seconds)),
                                tuple(tr["query_words"]))
        before = served.service.batcher.stats()
        w = drv.window(served, args.seed, rate, args.seconds, queries,
                       tr["k_mix"])
        after = served.service.batcher.stats()
        lat = w["latency_s"] * 1e3
        fifth = max(len(lat) // 5, 1)
        early, late = lat[:fifth].mean(), lat[-fifth:].mean()
        batches = after["batches"] - before["batches"]
        print(json.dumps({
            "rate": rate, "requests": len(lat), "failed": w["failed"],
            "p50_ms": drv.percentile(lat, 0.5),
            "p95_ms": drv.percentile(lat, 0.95),
            "over_limit": float((lat > args.limit_ms).mean()),
            "first_fifth_ms": float(early), "last_fifth_ms": float(late),
            "backlog_grew": bool(late > 2 * early and late > args.limit_ms),
            "mean_batch": (after["items"] - before["items"])
            / max(batches, 1),
            "generator_late_max_ms": float(w["late_s"].max() * 1e3)}),
            flush=True)
    served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
