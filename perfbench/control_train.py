"""The controls of the comparisons of the MoE and data-parallel V33
cells, run on one card at the cells' size.

    python3 perfbench/control_train.py --workload train_v33_kanana2_moe \\
        --seeds 11 12 13 [--runs control half_batch biased_weights ...] \\
        [--routes-only]

For each seed it puts a variant of the float32 reference in the
program's place and prints, as one JSON line, the numbers the comparison
reads against the float32 reference (``route_gap`` and ``weight_gap``
too, for the MoE cell, where both take the same rows), and under
``checks`` and ``correct`` the cell's own comparison of them
(``core/compare.checks`` against the traffic file's limits of the
readings the variant has). ``--routes-only`` (MoE cell) takes the first
micro-batch's forward alone and reads ``route_gap`` and ``weight_gap``:

- ``control``: every product one precision step below the configuration's
  bfloat16 (fp8 e4m3 operands, ``reference/precision.py``; the MoE
  router's products stay float32, as the configuration states them);
- ``half_batch``: the loss over half of each micro-batch;
- MoE cell only: ``biased_weights`` (the experts weighed by the biased
  scores), ``no_shared`` (the shared experts left out), ``flat_rope``
  (the pairs (i, i + 32) of q_pe and k_pe turned, not (2i, 2i + 1));
- data-parallel cell only: ``no_exchange`` (rank 0 steps on its own
  gradients: the exchange between the cards left out).

A step that returns its state unchanged reads 1 on ``update_gap`` by the
measure itself. The data-parallel cell's reference takes every rank's
micro-batches of a step in one process (consecutive rows: rank r's rows
of micro-batch m of step s start at ((s·accum + m)·ranks + r)·batch) and
divides by the ranks, as DDP averages; ``no_exchange`` takes rank 0's
micro-batches alone. The benchmark's runs never run
this; the limits in the traffic files were set from its readings and the
sound runs' (PERF.md). The same faults at a tiny size run on the CPU in
``perfbench/tests/test_perfbench_moe.py`` and ``test_perfbench_dp.py``.
"""

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import bench, texts  # noqa: E402
from perfbench.core.compare import checks, train_readings  # noqa: E402

MOE_RUNS = ("control", "half_batch", "biased_weights", "no_shared",
            "flat_rope")
DP_RUNS = ("control", "half_batch", "no_exchange")


def half(n: int):
    return range(n // 2)


def readings(run: dict, ref: dict) -> dict:
    return train_readings(run["losses"], ref["losses"], run["grad1"],
                          ref["grad1"], run["change"], ref["change"])


def judged(readings: dict, limits: dict) -> dict:
    """``readings`` with the cell's comparison of those it has."""
    got = checks(readings, {n: lim for n, lim in limits.items()
                            if n in readings})
    return {**readings, "checks": got,
            "correct": bench.Outcome({}, 0, 0, got, 0).correct}


def ref_routes(a: dict, b: dict, micro: dict) -> dict:
    """``route_gap`` and ``weight_gap`` of one reference's first
    micro-batch against another's."""
    import torch

    from perfbench.drivers.train_v33_moe import route_sums

    parts = []
    for name in a:
        mask = micro[name + "_mask"].bool().cpu()
        for layer in a[name]:
            parts.append(tuple(tuple(torch.cat(t) for t in zip(*r[name][layer]))
                               for r in (a, b)) + (mask,))
    return route_sums(parts)


def moe(cell, seed: int, device: str, runs, routes_only=False) -> dict:
    from perfbench.drivers import train_v33_moe as d

    tr, recipe = cell.traffic, d._recipe(cell, "")
    rowset = texts.triplets(seed, tr["triplets"], tuple(tr["query_words"]),
                            tuple(tr["doc_words"]))
    tok = texts.CharTokenizer(cell.config["vocab_size"])
    B = recipe["data"]["batch_size"]
    steps = [[list(range(s * B, (s + 1) * B))]
             for s in range(d.CHECKED_STEPS)]
    micro = d.collate_rows(rowset, tok, steps[0][0], recipe["data"], "cpu")
    kws = {"control": dict(mm_name="fp8"), "half_batch": dict(
        keep_rows=half)}
    out = {}
    if routes_only:
        ref = d.reference_routes(cell, seed, rowset, tok, steps[0][0],
                                 device, recipe)
        for name in runs:
            if name == "half_batch":
                continue
            got = d.reference_routes(cell, seed, rowset, tok, steps[0][0],
                                     device, recipe,
                                     **kws.get(name, dict(fault=name)))
            out[name] = judged(ref_routes(got, ref, micro), tr["limits"])
        return out
    ref = d.reference_readings(cell, seed, rowset, tok, steps, device, recipe)
    for name in runs:
        got = d.reference_readings(cell, seed, rowset, tok, steps, device,
                                   recipe, **kws.get(name, dict(fault=name)))
        r = readings(got, ref)
        if name != "half_batch":
            r.update(ref_routes(got["routes"], ref["routes"], micro))
        out[name] = judged(r, tr["limits"])
    return out


def dp(cell, seed: int, device: str, runs) -> dict:
    import torch

    from perfbench.drivers import train_v33_dp as d

    tr, recipe = cell.traffic, d._recipe(cell, "")
    rowset = texts.triplets(seed, tr["triplets"], tuple(tr["query_words"]),
                            tuple(tr["doc_words"]))
    tok = texts.CharTokenizer(cell.config["vocab_size"])
    B = recipe["data"]["batch_size"]
    accum = recipe["training"]["gradient_accumulation_steps"]
    W = tr["ranks"]
    steps = [[list(range(((s * accum + m) * W + r) * B,
                         ((s * accum + m) * W + r + 1) * B))
              for m in range(accum) for r in range(W)]
             for s in range(d.CHECKED_STEPS)]
    one = SimpleNamespace(device=torch.device(device), world=W,
                          distributed=False)
    ref = d.reference_readings(cell, seed, rowset, tok, steps, one, recipe)
    # rank 0's micro-batches of each step
    rank0 = [[idx for i, idx in enumerate(micro) if i % W == 0]
             for micro in steps]
    out = {}
    for name in runs:
        kw = {"control": dict(mm_name="fp8"),
              "half_batch": dict(keep_rows=half), "no_exchange": {}}[name]
        got = d.reference_readings(
            cell, seed, rowset, tok, rank0 if name == "no_exchange" else steps,
            one, recipe, **kw)
        out[name] = judged(readings(got, ref), tr["limits"])
    return out


KINDS = {"train_v33_moe": (moe, MOE_RUNS), "train_v33_dp": (dp, DP_RUNS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--runs", nargs="+", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--routes-only", action="store_true")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    if args.device == "cuda":  # as the MoE cell's driver runs
        import torch

        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    cell = bench.load_cell(args.workload)
    fn, runs = KINDS[cell.traffic["driver"]]
    for seed in args.seeds:
        kw = dict(routes_only=True) if args.routes_only else {}
        got = fn(cell, seed, args.device, args.runs or runs, **kw)
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
