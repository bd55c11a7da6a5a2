"""The controls of a cell's comparison, run on the card at the cell's size.

    python3 perfbench/control.py --workload <cell or config:traffic> \
        --seeds 11 12 13

For each seed it puts the reference in the program's place twice and
prints the numbers the comparison reads against the float32 reference,
as JSON lines:

- ``control``: the reference with every product one precision step below
  the configuration's bfloat16 (fp8 e4m3 operands, ``reference/precision``);
- ``half_batch`` (training cells): the reference taking its loss over half
  of each micro-batch, the mean over the rest.

A step that returns its state unchanged reads 1 on ``update_gap`` by the
measure itself and needs no run. The benchmark's runs never run this; the
limits in ``perfbench/traffic`` were set from its readings and the sound
runs' (PERF.md). The same comparisons at a tiny size run on the CPU in
``perfbench/tests/test_perfbench_controls.py``.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.core import bench, texts  # noqa: E402
from perfbench.core.compare import search_readings, train_readings  # noqa


def half(n: int):
    return range(n // 2)


def v33(cell, seed: int, device: str) -> dict:
    from perfbench.drivers import train_v33 as d

    tr, recipe = cell.traffic, d._recipe(cell, "")
    rowset = texts.triplets(seed, tr["triplets"], tuple(tr["query_words"]),
                            tuple(tr["doc_words"]))
    tok = texts.CharTokenizer(cell.config["vocab_size"])
    B = recipe["data"]["batch_size"]
    accum = recipe["training"]["gradient_accumulation_steps"]
    steps = [[list(range((s * accum + m) * B, (s * accum + m + 1) * B))
              for m in range(accum)] for s in range(d.CHECKED_STEPS)]
    runs = {name: d.reference_readings(cell, seed, rowset, tok, steps,
                                       device, recipe, mm, keep)
            for name, mm, keep in (("reference", "f32", None),
                                   ("control", "fp8", None),
                                   ("half_batch", "f32", half))}
    return compare_train(runs)


def mlm(cell, seed: int, device: str) -> dict:
    import torch

    from perfbench.drivers import train_mlm as d
    from splade_tpu_torch.train.mlm import MLMConfig

    tr = cell.traffic
    recipe = {k: v for k, v in cell.config["train_mlm"].items()
              if k != "model"}
    cfg = MLMConfig(**recipe)
    tok = texts.CharTokenizer(cell.config["vocab_size"])
    lines = texts.lines(seed, tr["lines"], tuple(tr["line_words"]))
    rows = torch.as_tensor(d.pack(lines, tok, cfg.max_length))
    P = d.masked_positions(cfg)
    g = torch.Generator().manual_seed(seed % (1 << 63))
    masked, at = [], 0
    for _ in range(d.CHECKED_STEPS):
        step = []
        for _ in range(cfg.grad_accum):
            ids = rows[at:at + cfg.batch_size].long()
            at += cfg.batch_size
            step.append(mask_rows(ids, P, tok, g))
        masked.append(step)
    runs = {name: d.reference_readings(cell, seed, lines, tok, masked,
                                       device, cfg, mm, keep)
            for name, mm, keep in (("reference", "f32", None),
                                   ("control", "fp8", None),
                                   ("half_batch", "f32", half))}
    return compare_train(runs)


def mask_rows(ids, P: int, tok, g) -> dict:
    """BERT masking of full rows by the control's own draws: P positions a
    row among the eligible ones, 80% [MASK], 10% a random token, 10% kept."""
    import torch

    eligible = (ids != tok.pad_token_id) & ~torch.isin(
        ids, torch.as_tensor(tok.all_special_ids))
    scores = torch.rand(ids.shape, generator=g) * eligible
    pos = torch.sort(scores, dim=1, descending=True).indices[:, :P]
    labels = ids.gather(1, pos)
    op = torch.rand(pos.shape, generator=g)
    rand = torch.randint(4, len(tok), pos.shape, generator=g)
    new = torch.where(op < 0.8, torch.full_like(labels, tok.mask_token_id),
                      torch.where(op < 0.9, rand, labels))
    return {"ids": ids, "corrupted": ids.scatter(1, pos, new), "pos": pos,
            "labels": labels,
            "weights": eligible.gather(1, pos).float()}


def compare_train(runs: dict) -> dict:
    ref = runs["reference"]
    return {name: {k: v for k, v in train_readings(
        r["losses"], ref["losses"], r["grad1"], ref["grad1"], r["change"],
        ref["change"]).items()} for name, r in runs.items()
        if name != "reference"}


def search(cell, seed: int, device: str) -> dict:
    import torch

    from perfbench.drivers import search as d
    from perfbench.reference import precision
    from perfbench.reference.search import (Corpus, exact_of, query_vectors,
                                            search as ref_search)
    from perfbench.core.weights import make_weights

    precision.tf32_off()
    tr, cfg = cell.traffic, cell.config
    spec = tr["index"]["kwargs"]
    c = tr["corpus"]
    terms, vals = texts.zipf_corpus_csr(seed, c["documents"],
                                        cfg["vocab_size"],
                                        c["terms_per_document"],
                                        c["zipf_exponent"])
    corpus = Corpus(terms, vals, cfg["vocab_size"], spec["n_postings"],
                    device)
    n = tr["check_requests"]
    queries = texts.queries(seed, n, tuple(tr["query_words"]))
    _, ks = d.arrivals(seed, n / 10.0, 10.0, tr["k_mix"])
    ks = [int(k) for k in ks]
    weights = make_weights(cfg, seed, device,
                           getattr(torch, cfg["serve"]["dtype"]),
                           cfg["serve"]["decoder_bias"])
    p = {name: w.float() for name, w in weights.items()}
    tok = texts.CharTokenizer(cfg["vocab_size"])
    out = {}
    ranked = {}
    dense = {}
    for name in ("f32", "fp8"):
        rep = query_vectors(p, cfg, tok, queries,
                            cfg["serve"]["query_max_length"],
                            tok.all_special_ids, device,
                            precision.PRODUCTS[name])
        ranked[name], dense[name] = ref_search(
            corpus, rep, ks, spec["query_top_t"], spec["rescore_candidates"])
    exact = exact_of(corpus, dense["f32"],
                     [[doc for doc, _ in r] for r in ranked["fp8"]])
    out["control"] = search_readings(
        ranked["fp8"], exact, [[s for _, s in r] for r in ranked["f32"]])
    return out


KINDS = {"train_v33": v33, "train_mlm": mlm, "search": search}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json, or config:traffic")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    cell = (bench.files_cell(args.workload, *args.workload.split(":"))
            if ":" in args.workload else bench.load_cell(args.workload))
    for seed in args.seeds:
        got = KINDS[cell.traffic["driver"]](cell, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
