"""The f32 rounding that separates two data-parallel halves from one process
at the global batch, on the card, beside the floors phase 7 (b) of
``chip_smoke.py`` could hold them to.

    python scripts/dp_noise_floors.py [--seeds 0 1]

For each seed: phase 7 (b)'s V33 model (22L/768/50K, splash route, layer
recompute, seeded random weights) and its first step's batches (the V33
recipe's per-step batch split over two ranks, ``chip_smoke.synth_triplets``
through the stand-in tokenizer), all in f32. One process at the global
batch (num_blocks 2) is the reference; against it, the loss, the gradients'
global norm and the worst gradient tensor (norm-relative) of:

- ``halves``: each rank's rows taken in turn, gradients combined as
  (g0 + g1) / 2 (``chip_smoke.combined_gradients``), what the ranks compute;
- ``regrouped``: the same blocks grouped into other micro-batches of the
  same row count;
- ``merged2``: micro-batches merged in pairs (twice the rows, 4 blocks);
- ``merged_all``: the whole step as one micro-batch (8 blocks), the floor
  phase 7 (b) takes.

Prints the card's name and power limit first, then one JSON line a
comparison (about a minute on an H100).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from splade_tpu_torch.config import V33Config  # noqa: E402
from splade_tpu_torch.data import TripletCollator  # noqa: E402
from splade_tpu_torch.models.modernbert import ModernBertConfig  # noqa: E402
from splade_tpu_torch.models.splade import SpladeEncoder  # noqa: E402

WORLD = cs.DP_WORLD
KEYS = ("loss_rel_err", "grad_norm_rel_err", "worst_tensor",
        "worst_tensor_rel_err")


def floors(seed: int) -> None:
    rng = np.random.default_rng([seed, 8])
    recipe = cs.v33_recipe()
    recipe["data"]["batch_size"] //= WORLD
    recipe["model"]["dtype"] = "float32"
    cfg = V33Config.from_dict(recipe)
    batch = cfg.data.batch_size
    accum = cfg.training.gradient_accumulation_steps
    collator = TripletCollator(
        cs.CharTokenizer(), query_max_length=cfg.data.query_max_length,
        doc_max_length=cfg.data.doc_max_length,
        num_hard_negatives=cfg.data.num_hard_negatives)
    macros = cs.rank_macro_batches(
        torch, cs.synth_triplets(rng, batch * WORLD * accum * 2), collator,
        batch, cfg.training.seed, accum, 1, WORLD, "cuda")[0]
    model = SpladeEncoder(ModernBertConfig(remat=True,
                                           attention_impl="splash"),
                          pool_impl="kernel", with_token_weights=False,
                          device="cuda").init_weights(seed)
    joined = {k: torch.cat([m[k] for m in macros], dim=1) for k in macros[0]}

    def step(macro, num_blocks):
        return cs.accumulated_gradients(torch, model, cs.v33_runs(
            torch, model, cfg, macro, 0, num_blocks=num_blocks))

    at_global = step(joined, WORLD)
    regrouped = {k: torch.stack([
        torch.cat([macros[r][k][(i + r) % accum] for r in range(WORLD)])
        for i in range(accum)]) for k in macros[0]}
    runs = {
        "halves": lambda: cs.combined_gradients(torch, model, [
            cs.v33_runs(torch, model, cfg, m, 0) for m in macros]),
        "regrouped": lambda: step(regrouped, WORLD),
        "merged2": lambda: step({k: v.reshape(accum // 2, 2 * v.shape[1],
                                              *v.shape[2:])
                                 for k, v in joined.items()}, 2 * WORLD),
        "merged_all": lambda: step({k: v.reshape(1, accum * v.shape[1],
                                                 *v.shape[2:])
                                    for k, v in joined.items()},
                                   accum * WORLD),
    }
    for name, run in runs.items():
        out = cs.gradients_against(torch, run(), at_global, name)
        print(json.dumps(dict(seed=seed, comparison=name,
                              **{k: out[k] for k in KEYS})), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dp_noise_floors: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for seed in args.seeds:
        floors(seed)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
