"""Tiny versions of the benchmark's cells for CPU runs of the tests: the
real configuration and traffic files with the model's widths and the
traffic's sizes cut, and the model computed in float32 (the sound program
then agrees with the reference to float32 rounding, so a planted fault is
the only thing that can move the comparison)."""

from perfbench.core import bench

TINY_MODEL = dict(vocab_size=12000, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=4, num_attention_heads=4,
                  local_attention=8, pad_token_id=11999)


#: the search mix kept for a later cell (PERF.md section 7), by its files
KEPT = {"serve_postings_1m5": ("ax-encoder-base-splade",
                               "postings_1m5_poisson")}


def tiny_cell(name: str, root=bench.ROOT) -> bench.Cell:
    cell = (bench.files_cell(name, *KEPT[name], root=root) if name in KEPT
            else bench.load_cell(name, root))
    cell.config.update(TINY_MODEL)
    tr = cell.traffic
    if tr["driver"] == "train_v33":
        tr["triplets"] = 96
        cell.config["train_v33"]["data"]["batch_size"] = 8
        cell.config["train_v33"]["model"]["dtype"] = "float32"
    elif tr["driver"] == "train_mlm":
        tr["lines"] = 400
        cell.config["train_mlm"].update(batch_size=4, max_length=64,
                                        dtype="float32")
    elif tr["driver"] == "search":
        tr["corpus"]["documents"] = 3000
        tr["rate_per_s"] = 40
        tr["check_requests"] = 16
        cell.config["serve"]["dtype"] = "float32"
        # the tiny head's maxima lie near 0.3: shifted by -0.3, a query
        # keeps a few terms, as the published widths do at -2.3
        cell.config["serve"]["decoder_bias"] = -0.3
    return cell


def run(cell, seed: int = 2 ** 31 + 11, seconds: float = 1.0,
        trace: bool = False):
    from perfbench import run as run_mod

    return run_mod.run_cell(cell, seed, seconds, trace, "cpu",
                            t_start=bench.now())
