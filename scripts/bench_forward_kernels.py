"""Time the port's two forward kernels, the fused SPLADE pool forward
(``splade_fused_pool_fwd``) and the splash attention forward
(``splade_splash_attn_fwd``), on one NVIDIA GPU, against the same C entries
built from an earlier checkout of the repo, and take the pool forward's
gain apart:

    git archive <commit> | tar -x -C build/parent   # build/ is git-ignored
    python scripts/bench_forward_kernels.py [--parent build/parent] [--rounds 2]

``--parent`` must be a directory under this checkout's ``build/``: its
``splade_tpu_torch/csrc`` is built into its own ``build/`` there and loaded
beside this tree's library. The calls are ``chip_smoke.py``'s own
(``pool_fwd_entry``, ``splash_fwd_entry``). Within a case every variant is
timed by CUDA events in one order and then in the reverse one
(``--rounds`` times), so that all meet the same clocks and the same L2.

The pool forward runs on the batches the port's paths give it, made with
``chip_smoke.py``'s data and stand-in tokenizer: one V33 micro-batch's
documents (B=128 S=256) and queries (B=64 S=64) as the trainer's collator
builds them, a served batch of 32 queries (6 words, 64 positions) and one of
32 indexed documents (60 words, 256 positions), and phase 2's random-length
batches (a fully padded row each); H=768, V=50,000. Its variants: this
tree's launch; the same launch on an all-valid mask (what it costs with no
padding to skip); the same launch with its blocks numbered batch range
first (``splade_fused_pool_fwd_batch_first``: equal operations, but the
blocks that run together no longer share a W tile in L2); the parent's
kernel. m and pos are compared bitwise between this tree's two block
orders and against the parent's. The attention runs at the training
micro-batches (B=144 S=256 with packed rows, B=32 S=512), 12 heads of 64,
half window 64 and 0, and at S=200, its outputs held to phase 2's
tolerances against the parent's. Prints one JSON line per kernel and case,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its data, calls and timer)
from splade_tpu_torch.ops import _cuda  # noqa: E402

SPLASH_CASES = ((144, 256, 64, True), (144, 256, 0, True),
                (32, 512, 64, False), (32, 512, 0, False),
                (3, 200, 64, False), (3, 200, 0, False))
H, V = 768, 50_000


def parent_checkout(path: Path) -> Path:
    """``path`` resolved, if it lies under this checkout's build/ directory
    (building it writes into it); else SystemExit."""
    path = path.resolve()
    build = (ROOT / "build").resolve()
    if build not in path.parents:
        raise SystemExit(f"--parent {path} is not under {build}")
    return path


def load_cuda_module(checkout: Path):
    """The ``_cuda`` module of another checkout, building from its sources
    into its own build directory."""
    path = checkout / "splade_tpu_torch" / "ops" / "_cuda.py"
    spec = importlib.util.spec_from_file_location("parent_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pool_masks(rng) -> dict:
    """name -> [B, S] f32 mask on the card: the pool forward's batches on
    the port's paths, and phase 2's random-length ones."""
    tok = chip_smoke.CharTokenizer()
    batches = chip_smoke.v33_pool_batches(tok, rng)
    masks = {f"V33 {what} B={B} S={S}": batches[(B, S)]["attention_mask"]
             for what, (B, S) in zip(("documents", "queries"),
                                     chip_smoke.TRAIN_POOL_SHAPES)}
    masks["served queries B=32 S=64"] = tok(
        chip_smoke.hangul_texts(rng, 32, 6), max_length=64)["attention_mask"]
    masks["indexed documents B=32 S=256"] = tok(
        chip_smoke.hangul_texts(rng, 32, 60),
        max_length=256)["attention_mask"]
    for B, S in ((32, 256), (32, 64), *chip_smoke.TRAIN_POOL_SHAPES):
        lens = rng.integers(1, S + 1, B)
        lens[-1] = 0
        masks[f"random lengths B={B} S={S}"] = (np.arange(S)[None]
                                                < lens[:, None])
    return {name: torch.from_numpy(np.asarray(m, np.float32)).cuda()
            for name, m in masks.items()}


def interleaved(runs: dict, rounds: int, iters: int) -> dict:
    """name -> mean ms of each run, timed in the order of ``runs`` and then
    in the reverse one, ``rounds`` times."""
    names = list(runs)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            times[name].append(chip_smoke.cuda_ms(torch, runs[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def bench_pool(libs: dict, rng, rounds: int) -> bool:
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 31)))
    w = (torch.randn((V, H), device="cuda", generator=gen) * 0.05).bfloat16()
    bias = torch.randn((V,), device="cuda", generator=gen) * 0.1
    ok = True
    for name, mask in pool_masks(rng).items():
        B, S = mask.shape
        h = torch.randn((B, S, H), device="cuda", generator=gen).bfloat16()

        def entry(lib, m, c_entry="splade_fused_pool_fwd"):
            return chip_smoke.pool_fwd_entry(torch, lib, h, w, bias, m,
                                             c_entry)

        calls = {"tree": entry(libs["tree"], mask),
                 "tree_all_valid": entry(libs["tree"], torch.ones_like(mask)),
                 "tree_batch_first": entry(
                     libs["tree"], mask, "splade_fused_pool_fwd_batch_first")}
        if "parent" in libs:
            calls["parent"] = entry(libs["parent"], mask)
        ms = interleaved({k: run for k, (run, _) in calls.items()}, rounds,
                         iters=10)
        out = {k: outs for k, (_, outs) in calls.items()}
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
        row = dict(kernel="splade_fused_pool_fwd", case=name,
                   valid_share=float(mask.mean()),
                   live_group_share=chip_smoke.live_group_share(torch, mask),
                   ms={k: ms[k] for k in calls},
                   padding_skip_saves_ms=ms["tree_all_valid"] - ms["tree"],
                   block_order_saves_ms=ms["tree_batch_first"] - ms["tree"],
                   orders_bitwise_equal=same(out["tree"],
                                             out["tree_batch_first"]))
        ok &= row["orders_bitwise_equal"]
        if "parent" in calls:
            row["parent_bitwise_equal"] = same(out["tree"], out["parent"])
            ok &= row["parent_bitwise_equal"]
        print(json.dumps(row), flush=True)
    return ok


def bench_splash(libs: dict, rng, rounds: int) -> bool:
    ok = True
    for B, S, hw, packed in SPLASH_CASES:
        q, k, v, seg, _ = chip_smoke.splash_case(
            torch, rng, B, S, chip_smoke.SPLASH_HEADS,
            chip_smoke.SPLASH_HEAD_DIM, packed)
        calls = {name: chip_smoke.splash_fwd_entry(torch, lib, q, k, v, seg,
                                                   hw)
                 for name, lib in libs.items()}
        ms = interleaved({k: run for k, (run, _) in calls.items()}, rounds,
                         iters=20)
        row = dict(kernel="splade_splash_attn_fwd", B=B, S=S,
                   half_window=hw, packed=packed, ms=ms)
        if "parent" in calls:
            (o1, l1), (o0, l0) = calls["tree"][1], calls["parent"][1]
            out_err = float((o1.float() - o0.float()).abs().max()
                            / o0.float().abs().max())
            lse_err = float((l1 - l0).abs().max())
            agree = (out_err <= chip_smoke.SPLASH_RTOL
                     and lse_err <= chip_smoke.SPLASH_LSE_ATOL)
            row.update(out_rel_err=out_err, lse_abs_err=lse_err, agree=agree)
            ok &= agree
        print(json.dumps(row), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    parent = parent_checkout(args.parent) if args.parent else None
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    libs = {"tree": _cuda.library()}
    if parent is not None:
        libs["parent"] = load_cuda_module(parent).library()
    rng = np.random.default_rng(args.seed)
    with torch.no_grad():
        ok = bench_pool(libs, rng, args.rounds)
        ok &= bench_splash(libs, rng, args.rounds)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0] if card.stdout else "unknown")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
