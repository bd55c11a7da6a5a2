"""Drive the PyTorch/CUDA port's serving, training and pre-training paths
once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; nothing is caught):

1. The card's name and power limit; the Hopper kernels built from
   ``splade_tpu_torch/csrc`` with their ptxas register/shared-memory/spill
   report, spelled out for the kernels last redesigned (``REDESIGNED``).
2. Each kernel against its plain PyTorch version, in bf16 on the card: the
   fused SPLADE pool forward at query encode (B=32, S=64) and document
   encode (B=32, S=256) with H=768, V=50,000 and a fully padded row, and at
   the training shapes below (pooled values, token weights, m and pos); the
   exact rescore at B=32, C=1000, M=64, T=64 over a 1M-document doc-major
   block (against exact_rescore and its plain version, a repeated call
   bitwise equal); the pool's kernels at the training shapes (docs B=128,
   S=256; queries B=64, S=64) and at B=8, S=200 (a ragged last bitmask
   word): the forward wrapper against the plain forward, and for the
   backward (the per-row family's match pass, dh gather and dW gather) the
   whole kernel route against the whole plain route: (a) small-integer inputs
   elementwise, (b) the model's own states by norm, (c) the recompute
   against the forward kernel's maxima, every row with its exact ties
   counted, a repeated backward bitwise equal; the match pass alone, its
   bitmask bitwise the plain one on (a) and every maximum found on (b).
   Times by CUDA events (the match pass and each gather apart and
   together), the bound from the shapes and this run's matches, and a
   library yardstick composed of cuBLAS calls where one exists. The
   row-blocked family (``ops/fused_splade_v2.py``) is held on the same
   inputs, at row_block 8 and 2, to the same checks and tolerances: forward
   against its plain version with m and pos bitwise equal to the per-row
   kernel's; backward checks (a), (b), (c), a repeated backward bitwise
   equal; its match pass alone, its bitmask bitwise the per-row match
   pass's on (a) and (b) and the plain one's on (a), every maximum found;
   its times (the match pass, each gather, each gradient's kernels and the
   whole backward) beside the per-row family's, the bound, the plain
   version, the cuBLAS composition and the recomputing kernels this
   design replaced (PERF.md). These training shapes are the
   row-blocked pool's own path (phase 5) launches its kernels at. The three
   splash attention kernels (``ops/splash_attention.py``) at the training
   micro-batches (B=144, S=256 with packed query rows; B=32, S=512), 12
   heads of 64, half window 64 and 0, random lengths and a fully padded
   row: the forward's out and lse, the dq kernel's delta, and dq, dk, dv
   for a seeded dO, against the plain versions; the same at a ragged
   S=200; the gradients through autograd equal to the wrappers' own and a
   repeated backward bitwise equal; times (each kernel, and the whole
   backward as the autograd.Function runs it: the dq kernel with delta,
   then dk/dv), bounds from the allowed pairs, and one
   ``scaled_dot_product_attention`` call with the same mask as the library
   yardstick (timed here, called nowhere in the port).
3. The serving path at full width (22 layers, 768 hidden, 50K vocab) with
   seeded random weights and a character-level stand-in tokenizer: a
   two-phase PostingsIndex over 1,000,000 synthetic documents plus a few
   hundred model-encoded ones, and a dense int8 engine over 10,000
   documents, each behind the HTTP server; /healthz, /search (k=10, 100),
   /encode, /index then /search through the LSM delta. The batched /search
   results, and the indexed text documents' vectors, are held against the
   port's plain path (pool_impl="streamed", exact_rescore) on the same
   inputs; each index's own ``search_vector`` on one query's vector against
   the engine's search of that query. The kernels' launch counts are set to 0 before this phase and
   read after it, and per served request and batch around the
   single-query requests. Then one warmed search batch
   of 8 and of 32 queries per engine under torch.profiler: wall time,
   device busy time and idle share, and the kernels that take most time.
4. The training path at full width with the canonical V33 recipe of
   ``configs/train_v33.yaml`` (batch 64, accumulation 4, query 64, doc 256,
   one hard negative, packed query tower, bf16 autocast, layer recompute,
   lr 5e-5): synthetic Hangul triplets written as JSONL and read through
   load_training_data -> TripletCollator -> Trainer. One warm-up step, then
   3 optimizer steps through the kernels with the launch counts set to 0
   before and read after (2 x accumulation a step for each pool kernel:
   the forward, the match pass and the two gathers),
   triplets/s, step time and peak memory; one step under torch.profiler; a
   checkpoint resumed by a fresh Trainer that must take the same step (at
   the schedule's learning rate for that step, above 0); one micro-batch
   held against the plain route (pool_impl="streamed"). The measured steps
   run with the hang watchdog armed: it must count beats and stay quiet.
5. MLM pre-training at full width with the recipe of
   ``configs/pretrain_mlm.yaml`` (batch 32 x 512 tokens, accumulation 4,
   lr 5e-5, warm-up 0.05, masking probability 0.15, bf16 autocast) on a
   synthetic Hangul corpus written as a text shard and read through
   read_corpus -> pack_corpus -> MLMTrainer. One run: a warm-up step, 3
   measured steps (tokens/s, ms a step), then SIGTERM to this process: the
   trainer must stop at a step boundary, write a checkpoint and return,
   and the previous signal handlers are put back. The next step is taken
   under torch.profiler by the live trainer and again by a fresh trainer
   resumed from the checkpoint: loss and parameters must be bitwise equal.
   Held-out evaluation; the final model saved, loaded by
   SparseEncoderV33.from_checkpoint, held against the in-memory weights
   cast to bf16, and served from a small dense engine. Last, the
   row-blocked pool family's own path, its public function under autograd:
   the pre-trained model's states, at the training shapes phase 2 held the
   family at, pooled by fused_splade_pool_v2 with a sparsity loss, backward into the model, with the family's launch counts
   set to 0 before and read after (one forward, one match pass and one
   gather a gradient, a batch), held against the per-row family's route;
   then its whole backward timed on each of those batches (short texts,
   mostly padding), with their valid share.
6. Both training paths with ``attention_impl="splash"`` at full width:
   phase 4 again (warm-up, 3 measured steps through ``Trainer``, a profiled
   step, the bitwise resume, the plain pool route) and phase 5 again (3
   measured steps through ``MLMTrainer``, SIGTERM, bitwise resume,
   evaluation, ``from_checkpoint`` and a served engine, all on the splash
   route) through the attention kernels. The launch counts must be the ones
   the code implies (V33 with layer recompute: 22 x 2 forward, 22 dq, 22
   dk/dv a micro-batch; MLM: 22 of each), one micro-batch's loss and
   gradients are held against the sdpa route on the same weights and batch,
   and throughput, step time, idle share and peak memory are printed
   beside phase 4's and 5's.
7. Data-parallel training over ``torch.distributed``, each run in
   processes of its own under a deadline (a hung collective fails the
   phase). (a) The V33 CLI (``python -m splade_tpu_torch.train v33``,
   through ``--cli``: the stand-in tokenizer in place of the HF one) on
   phase 4's recipe, written as a JSON config, and synthetic JSONL
   triplets, 3 steps: once as one process, once under
   ``torch.distributed.run --standalone --nproc_per_node 1 ...
   --distributed`` (NCCL). Every logged step's results and the final
   model bitwise equal; the gradient all-reduce's ms a step (CUDA events)
   and triplets/s beside phase 4's; the pool kernels' launches 2 x
   accumulation a step. (b) Two ranks on this one card over gloo (whose
   all-reduce takes CUDA tensors through the host: a correctness run, not
   NCCL's speed), each with half of the recipes' per-step batches on the
   splash route: V33 through ``Trainer`` (2 steps), again with SIGTERM to
   rank 1 alone, one step with global in-batch negatives, MLM through
   ``MLMTrainer`` (2 steps). Held: both ranks' logged numbers identical,
   and with the parameters bitwise equal to the same halves taken in turn
   in this process, gradients combined as (g0 + g1) / 2
   (``emulate_ranks_step``); each rank's launch counts; rank 0's the only
   checkpoint; after the SIGTERM both ranks stopped at step 2 with one
   checkpoint. Then, with autocast off (f32), the emulation's first step
   against one process at the global batch with num_blocks 2, and the
   ranks' step with global in-batch negatives against one process with
   them, to twice a noise floor measured first (that process's gradient
   with the step's micro-batches taken as one, their blocks masked apart),
   within ``DP_RTOL``. (c) The MLM CLI on phase 5's recipe, 2
   steps, one process against a world of 1 over NCCL: bitwise. A rank on
   another card (``cuda:1``) and NCCL across cards are not run: the card
   machine has one card.

The last six lines are the training JSON, the pre-training JSON, the
splash training JSON, the data-parallel JSON, the kernels' JSON and the
run's JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_FP32_OPS = 67e12      # non-tensor f32/int32 lane operations
H100_BYTES = 3.35e12       # HBM3 bandwidth

V = 50_000
POSTINGS_DOCS = 1_000_000  # synthetic documents of the postings engine
POOL_TOL = 1e-3      # bf16 products are exact in f32; only sum order differs
RESCORE_TOL = 1e-4   # the reference's own rescore tolerance
# served vs plain path, relative to each query's top score (or each
# document's largest weight): f32 sum order alone gives about 1e-6, and a
# dropped bias or a wrong term in a score moves it by far more than 1e-4
SERVE_RTOL = 1e-4
# backward kernels vs plain versions. (a) exact inputs: only the order of
# f32 sums differs (about 1e-7 of a tensor's largest value). (b) model
# states: a near-tie may pick another argmax in the two routes and move one
# W row; norm-relative. (c) with g_pre = 1, sum_s dh[b] = sum_v n[b,v] W[v]
# with n the count of positions that reach the maximum (1, or more at an
# exact f32 tie): once each row's ties are counted, only f32 sum order is
# left (about 1e-6), while one column lost or added moves the row by about
# 1/sqrt(V) (4.5e-3 at V=50,000). Tie candidates: positions whose f32
# score is within RECOMPUTE_TIE_RTOL of the column's best (the two sum
# orders differ by about 1e-6 of it).
BWD_EXACT_RTOL = 1e-5
BWD_NORM_RTOL = 1e-2
RECOMPUTE_RTOL = 1e-3
RECOMPUTE_TIE_RTOL = 1e-4
# training, kernel route vs plain route on one micro-batch from the same
# parameters and bf16-exact embedding: the backbone is shared, the pool's
# products are exact in both, only f32 sum order (and a rare near-tie's
# argmax) differs, then bf16 autocast rounds the backward; dropping dbias
# or losing the argmax moves a gradient by about 1
TRAIN_RTOL = 1e-3
TRAIN_GRAD_RTOL = 2e-2
# resume: the kernels and the step are deterministic, so the resumed step
# should be bitwise; anything beyond f32 noise is a fault
RESUME_ATOL = 1e-6
# the hang watchdog's window in phases 4 and 5: far above a step and a
# checkpoint write, so a healthy run never trips it
WATCHDOG_S = 600.0
# final model -> from_checkpoint vs the in-memory weights cast to bf16: the
# same bf16 numbers through the same kernels, so the vectors should be
# bitwise equal; held to the serving tolerance
CHECKPOINT_RTOL = SERVE_RTOL
# the row-blocked family's route vs the per-row family's through one model
# backward: pooled is bitwise equal (same scores, a maximum has no order);
# dh differs by the order in which vocab splits are added (about 1e-6), which
# bf16 autocast then carries through 22 layers; held to the training limits
# TRAIN_RTOL (loss, gradient norm) and TRAIN_GRAD_RTOL (each tensor)
# row_block values the row-blocked family is held at: the default at these
# batch sizes, and a smaller one
V2_ROW_BLOCKS = (8, 2)
# (B, S, row_block) -> {"dh", "dw": ms} of the row-blocked family's first
# backward (one kernel a gradient, each recomputing every score with a 64-row
# W tile resident in shared memory), which its match pass and gathers
# replaced: PERF.md §6 rows 5-6, on an H100 80GB HBM3 at 700 W, logged
# beside this run's times (not measured here, so not in the kernels line)
RECOMPUTE_KERNELS_MS = {
    (128, 256, 8): {"dh": 111.45, "dw": 44.17},
    (128, 256, 2): {"dh": 103.97, "dw": 44.34},
    (64, 64, 8): {"dh": 29.53, "dw": 11.17},
    (64, 64, 2): {"dh": 38.99, "dw": 11.25}}
# (B, S, row_block) -> ms of the row-blocked family's first forward (a 64-row
# W tile resident in shared memory, the row block's flattened rows walked in
# WMMA chunks padding included), which the walk forward replaced: PERF.md §6
# row 4, on an H100 80GB HBM3 at 700 W, logged beside this run's times (not
# measured here, so not in the kernels line)
RESIDENT_TILE_FWD_MS = {(32, 256, 8): 5.616, (32, 64, 8): 1.873,
                        (32, 256, 2): 5.843, (32, 64, 2): 2.182}
# ms of the first rescore kernel (one thread a candidate, each slot compared
# with every query term) at check_rescore's shape: PERF.md §6 rows 7-8, as
# above
SCAN_RESCORE_MS = 0.0542
# (B, S) of the pool at training: documents (64 positives + 64 negatives)
# and unpacked queries. Phase 2 holds every family's forward and backward
# wrappers against the plain versions at these shapes, and phase 5 launches
# the row-blocked family at them (row_block 0, which resolves to
# V2_ROW_BLOCKS[0] at both batch sizes)
TRAIN_POOL_SHAPES = ((128, 256), (64, 64))
# a backward shape whose S is not a multiple of the bitmask's 32-position
# words (the last word of every row is ragged)
BWD_RAGGED = (8, 200)
# splash attention kernels vs plain versions on the same bf16 operands, with
# the same lse fed to both backward routes (the kernels' delta is their own,
# the plain route's the plain reduction: within SPLASH_DELTA_RTOL of each
# other, far below the ulp below). Scores and sums are f32
# in both (the order of sums and the kernels' fast exp differ by about 1e-6),
# then two roundings to bf16 remain: p (and ds) before the second product,
# where a 1e-6 difference can flip one value by an ulp (2^-8 of it), and the
# kernel's bf16 out against the plain version's f32 (half an ulp: 2^-9).
# out, dq, dk, dv: elementwise, relative to the tensor's largest value; lse:
# absolute (one key lost from a window of 129 moves a row's lse by about
# 8e-3, a dropped delta moves ds by its whole size)
SPLASH_RTOL = 2.0 ** -7
SPLASH_LSE_ATOL = 1e-4
# delta = rowsum(dO * out), the dq kernel's against the plain reduction on the
# same bf16 values: f32 sums of 64 products in another order (about 1e-6 of
# the largest value); a dropped or stale delta is off by its whole size
SPLASH_DELTA_RTOL = 1e-5
# (B, S) of the attention at training: the V33 micro-batch (128 document rows
# + 16 rows of 4 packed queries, 256 positions) and the MLM one (32 x 512);
# 12 heads of 64; the local layers' half window and the global layers' 0
SPLASH_SHAPES = ((144, 256), (32, 512))
SPLASH_HEADS, SPLASH_HEAD_DIM = 12, 64
SPLASH_WINDOWS = (64, 0)
SPLASH_RAGGED = (3, 200)  # S not a multiple of the kernels' 64-row tile
# training, splash route vs sdpa route on one micro-batch from the same
# parameters: valid positions see the same function, but under bf16 autocast
# the sdpa route rounds its scores to bf16 before the softmax where the
# kernels keep them in f32, in each of 22 layers, and every later activation
# carries that noise (about 2^-9 a value); a wrong window or a backward that
# drops delta moves the gradients by their whole size
SPLASH_TRAIN_RTOL = 1e-2
# each gradient tensor, norm-relative: twice the noise floor that
# compare_attention_routes measures first (the sdpa route with nothing
# changed but its scores kept in f32, against the sdpa route), no less than
# the f32 sum-order difference of a CPU run and no more than 0.3. With seeded
# random weights the bf16 V33 step is very sensitive: the floor is about 0.14
# for the worst tensor there and 0.008 in the MLM step; a backward whose dv
# never arrives moves the attention weights' gradients by their whole size
SPLASH_TRAIN_GRAD_RTOL = (1e-3, 0.3)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------- stand-ins
class CharTokenizer:
    """Deterministic character-level stand-in for the A.X-Encoder
    tokenizer (which is not in the repository): one id per non-space
    character, ids 0-3 special, [PAD] = 0. Called with
    ``add_special_tokens=False`` it returns unpadded id lists, as
    ``pack_corpus`` asks of a tokenizer. ``fill`` counts the valid and the
    padded-to positions of the padded batches it makes, by max_length: the
    masks the encoders and the collator hand the pool forward."""

    pad_token_id = 0
    cls_token_id = 1
    sep_token_id = 2
    mask_token_id = 3
    all_special_ids = [0, 1, 2, 3]

    def __init__(self):
        self.fill = {}  # max_length -> [valid positions, positions]
        self._lock = threading.Lock()  # the collator runs in a loader thread

    def __len__(self):
        return V

    def get_vocab(self):
        return {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[MASK]": 3}

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=64, return_tensors="np", add_special_tokens=True):
        all_codes = [[4 + ord(c) % (V - 4) for c in t if not c.isspace()]
                     for t in texts]
        if not add_special_tokens:
            return {"input_ids": all_codes}
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, codes in enumerate(all_codes):
            codes = codes[:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        with self._lock:
            tally = self.fill.setdefault(max_length, [0, 0])
            tally[0] += int(mask.sum())
            tally[1] += mask.size
        return {"input_ids": ids, "attention_mask": mask}

    def valid_share(self) -> dict:
        """max_length -> the share of valid positions in the padded batches
        made since ``fill`` was last cleared."""
        with self._lock:
            return {n: v / max(p, 1) for n, (v, p) in self.fill.items()}


def hangul_texts(rng, n: int, words: int) -> list:
    stems = ["".join(chr(0xAC00 + int(x)) for x in rng.integers(0, 11172, 2))
             for _ in range(400)]
    return [" ".join(stems[j] for j in rng.integers(0, len(stems), words))
            for _ in range(n)]


def zipf_corpus_csr(rng, n_docs: int, nnz: int = 54):
    """A synthetic corpus after the reference benches' generator
    (``splade_tpu/utils/synth.py``: Zipf(1.3) term ids mod the vocabulary,
    |N(0,1)|+0.1 impacts, 54 draws per document), with one departure. That
    generator keeps repeated draws, so a row holds about 29 distinct ids and
    the Zipf head repeats within it. A sparse vector holds each term once,
    so here a term drawn twice in one row is redrawn uniformly until the
    row's 54 ids are distinct (rows come out sorted). About 25 draws a row
    move from the Zipf head to uniform terms, which lengthens the postings
    of the vocabulary's tail against the reference's corpus."""
    terms = (rng.zipf(1.3, size=(n_docs, nnz)) % V).astype(np.int32)
    while True:
        terms.sort(axis=1)
        dup = np.zeros(terms.shape, bool)
        dup[:, 1:] = terms[:, 1:] == terms[:, :-1]
        n_dup = int(dup.sum())
        if not n_dup:
            break
        terms[dup] = rng.integers(0, V, n_dup)
    vals = (np.abs(rng.normal(size=(n_docs, nnz))) + 0.1).astype(np.float32)
    return terms, vals


# ----------------------------------------------------------------- timing
def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int, replays: int = 5) -> float:
    """Device ms of one ``fn()``, which launches on torch's current stream:
    a CUDA graph of ``iters`` calls, replayed and timed by CUDA events. A
    kernel of a few microseconds takes less time than Python needs to
    launch it, so timed call by call (cuda_ms) it measures the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return cuda_ms(torch, graph.replay, iters=replays, warmup=1) / iters


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes = bytes_moved / H100_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ phase 1
PTXAS_ENTRY = re.compile(r"\d((?:fused_splade|splash|rescore)\w*?_kernel)[EI]")
PTXAS_NUMBERS = {
    "stack_bytes": re.compile(r"(\d+) bytes stack frame"),
    "spill_store_bytes": re.compile(r"(\d+) bytes spill stores"),
    "spill_load_bytes": re.compile(r"(\d+) bytes spill loads"),
    "registers": re.compile(r"Used (\d+) registers"),
    "static_smem_bytes": re.compile(r"(\d+) bytes smem"),
}
#: the kernels this slice redesigned, whose ptxas report phase 1 spells out:
#: the exact rescore, and the walk forward that the row-blocked family's
#: forward now launches too
REDESIGNED = ("rescore_kernel", "fused_splade_fwd_kernel")


def ptxas_summary(build_log: str) -> dict:
    """kernel name -> a list (one per compiled instance) of what ptxas
    reported for it: registers, static shared memory, stack frame and
    spilled bytes. Numbers ptxas leaves out (no static shared memory) are
    0."""
    out, current = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            found = PTXAS_ENTRY.search(line)
            current = dict.fromkeys(PTXAS_NUMBERS, 0) if found else None
            if found:
                out.setdefault(found.group(1), []).append(current)
            continue
        if current is None:
            continue
        for key, pattern in PTXAS_NUMBERS.items():
            hit = pattern.search(line)
            if hit:
                current[key] = int(hit.group(1))
    return out


# ------------------------------------------------------------ phase 2
def pool_fwd_entry(torch, lib, h, w, bias, maskf,
                   entry: str = "splade_fused_pool_fwd"):
    """A call of the pool forward's C entry ``entry`` of ``lib`` (a built
    kernel library, this checkout's or another's) on [B, S, H] bf16 h, [V, H]
    bf16 w, f32 bias and f32 mask, without the wrapper's conversions or
    launch count: (run, (m [B, V], pos_key [B, S])), run refilling pos_key
    with key(-1e30) first, as the wrapper does."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import float_key

    B, S, H = h.shape
    V_ = w.shape[0]
    m_out = torch.empty((B, V_), dtype=torch.float32, device="cuda")
    neg_key = int(float_key(torch.tensor(-1e30)))
    pos_key = torch.full((B, S), neg_key, dtype=torch.int32, device="cuda")

    def run():
        pos_key.fill_(neg_key)
        _cuda.check(getattr(lib, entry)(
            h.data_ptr(), w.data_ptr(), bias.data_ptr(), maskf.data_ptr(),
            m_out.data_ptr(), pos_key.data_ptr(), B, S, H, V_,
            torch.cuda.current_stream().cuda_stream), entry)
    return run, (m_out, pos_key)


def splash_fwd_entry(torch, lib, q, k, v, seg, half_window: int):
    """A call of the splash forward's C entry of ``lib`` on q, k, v [B, N, S,
    D] (strided views) and seg [B, S], without the wrapper: (run, (out
    [B, S, N, D] bf16, lse [B, N, S] f32))."""
    import math

    from splade_tpu_torch.ops import _cuda

    B, N, S, D = q.shape
    out = torch.empty((B, S, N, D), dtype=torch.bfloat16, device="cuda")
    lse = torch.empty((B, N, S), dtype=torch.float32, device="cuda")
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]

    def run():
        _cuda.check(lib.splade_splash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *strides, B, N, S, D, half_window,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream),
            "splade_splash_attn_fwd")
    return run, (out, lse)


def live_group_share(torch, mask) -> float:
    """The share of a [B, S] mask's 16-position groups (positions 16i..16i+15
    of one row, the last one ragged) that hold a valid position: the part
    of the full work that the pool forward, which skips the others, does."""
    B, S = mask.shape
    if B * S == 0:
        return 0.0
    pad = -S % 16
    grouped = torch.nn.functional.pad(mask.float(), (0, pad)).view(B, -1, 16)
    return float((grouped > 0).any(2).float().mean())


def v33_pool_batches(tok, rng) -> dict:
    """The pool forward's inputs in one V33 micro-batch, as the trainer's
    collator builds them from ``synth_triplets`` (phase 4's data): the
    documents (positives, then negatives) and the queries, each
    {"input_ids", "attention_mask"} in numpy, keyed by their (B, S), which
    are TRAIN_POOL_SHAPES."""
    from splade_tpu_torch.data import TripletCollator

    data = v33_recipe()["data"]
    collate = TripletCollator(tok, query_max_length=data["query_max_length"],
                              doc_max_length=data["doc_max_length"])
    got = collate(synth_triplets(rng, data["batch_size"]))
    names = ("input_ids", "attention_mask")
    docs = {k: np.concatenate([got[f"positive_{k}"], got[f"negative_{k}"]])
            for k in names}
    queries = {k: got[f"query_{k}"] for k in names}
    return {x["attention_mask"].shape: x for x in (docs, queries)}


def check_pool(torch, model, tok, rng, B: int, S: int, v2: bool = True,
               device: str = "cuda", timed: bool = True,
               enc: dict = None) -> dict:
    """The wrapper ``fused_splade_pool`` against its plain version at one
    encode shape, on the model's own states: pooled values and token
    weights, and the maxima wrapper's m and pos (pos at the valid
    positions), within POOL_TOL; every fully padded row zero. The batch is
    ``enc`` ({"input_ids", "attention_mask"} [B, S], as a path's collator or
    encoder made it) or else random lengths with the last row padded. Timed
    (on the card): the C entry alone, the same on an all-valid mask (the
    time of the same launch with no padding to skip), the plain version, a
    cuBLAS yardstick and the bound from this run's valid positions. With
    ``v2`` the row-blocked family on the same inputs (``check_pool_v2``)."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import (fused_splade_maxima,
                                                   fused_splade_pool,
                                                   fused_splade_pool_plain)

    cut = None
    if enc is None:
        enc = tok(hangul_texts(rng, B, S), max_length=S)
        lens = torch.from_numpy(rng.integers(1, S + 1, B)).to(device)
        cut = torch.arange(S, device=device)[None] < lens[:, None]
        cut[-1] = False                           # a fully padded row
    ids = torch.from_numpy(enc["input_ids"]).to(device)
    mask = torch.from_numpy(enc["attention_mask"]).to(device)
    if tuple(mask.shape) != (B, S):
        raise SystemExit(f"check_pool: a batch of {tuple(mask.shape)} given "
                         f"for B={B} S={S}")
    if cut is not None:
        mask = mask * cut
    with torch.no_grad():
        h = model.mlm.head_transform(model.mlm.encode(ids, mask)).contiguous()
    w, bias_param = model.mlm.decoder_weights()
    w, bias = w.detach(), bias_param.detach().float().contiguous()
    maskf = mask.float().contiguous()
    H = h.shape[-1]
    V_ = w.shape[0]

    with torch.no_grad():
        # the model's own (bf16) bias and the int mask, as the encoder
        # passes them: the wrapper does the conversions
        pooled, tw = fused_splade_pool(h, w, bias_param, mask)
        m, pos = fused_splade_maxima(h, w, bias_param, mask)
        empty, empty_tw = fused_splade_pool(h[:0], w, bias_param, mask[:0])
        m_ref, pos_ref = fused_splade_pool_plain(h, w, bias, maskf)
    if device == "cuda":
        torch.cuda.synchronize()
    ref_pooled = torch.log1p(torch.relu(m_ref))
    ref_tw = torch.log1p(torch.relu(pos_ref)) * maskf
    valid = maskf > 0
    padded = ~valid.any(1)
    err = max(float((pooled - ref_pooled).abs().max()),
              float((tw - ref_tw).abs().max()))
    maxima_err = max(float((m - m_ref).abs().max()),
                     float((pos - pos_ref)[valid].abs().max())
                     if bool(valid.any()) else 0.0)
    padded_zero = (float(pooled[padded].abs().sum()) == 0.0
                   and float(tw[padded].abs().sum()) == 0.0)
    log(f"  pool B={B} S={S}: max |err| {err:.3e}, maxima m and pos "
        f"{maxima_err:.3e} (tol {POOL_TOL}), {int(padded.sum())} fully "
        f"padded rows zero: {padded_zero}, nnz/row "
        f"{float((pooled > 0).sum(1)[~padded].float().mean()):.0f}")
    if not (err <= POOL_TOL and maxima_err <= POOL_TOL and padded_zero):
        raise SystemExit(f"fused pool kernel disagrees (B={B}, S={S})")
    if empty.shape != (0, V_) or empty_tw.shape != (0, S):
        raise SystemExit(f"fused pool on an empty batch gave "
                         f"{tuple(empty.shape)}, {tuple(empty_tw.shape)}")
    out = dict(shape=f"B={B} S={S} H={H} V={V_}",
               max_abs_err=max(err, maxima_err),
               valid_share=float(maskf.mean()),
               live_group_share=live_group_share(torch, maskf))
    if timed:
        lib = _cuda.library()
        kernel, _ = pool_fwd_entry(torch, lib, h, w, bias, maskf)
        full, _ = pool_fwd_entry(torch, lib, h, w, bias,
                                 torch.ones_like(maskf))

        def library():
            logits = torch.matmul(h.view(B * S, H), w.T).view(B, S, V_)
            return (logits.float() + bias).masked_fill(
                maskf[:, :, None] == 0, -1e30).amax(1)

        with torch.no_grad():
            ms = cuda_ms(torch, kernel, iters=20)
            full_mask_ms = cuda_ms(torch, full, iters=20)
            plain_ms = cuda_ms(torch, lambda: fused_splade_pool_plain(
                h, w, bias, maskf), iters=3, warmup=1)
            library_ms = cuda_ms(torch, library, iters=5, warmup=1)
        n_valid = float(maskf.sum())
        ops = 2.0 * n_valid * H * V_
        moved = h.numel() * 2 + w.numel() * 2 + V_ * 4 + B * S * 4 \
            + B * V_ * 4 + B * S * 4
        bound_ms, bound_by = bound(moved, ops, H100_BF16_FLOPS)
        log(f"  pool B={B} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {ops:.3e} FLOP over {n_valid:.0f} valid tokens, "
            f"{moved / 1e6:.1f} MB; {bound_ms / ms:.1%} of it); "
            f"{out['valid_share']:.1%} of positions valid, "
            f"{out['live_group_share']:.1%} of 16-row groups live; on an "
            f"all-valid mask {full_mask_ms:.4f} ms")
        out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms,
                   full_mask_ms=full_mask_ms)
    if v2:
        out["v2"] = {rb: check_pool_v2(torch, h, w, bias_param, bias, mask,
                                       rb, out, (ref_pooled, ref_tw),
                                       device=device, timed=timed)
                     for rb in V2_ROW_BLOCKS}
    return out


def check_pool_v2(torch, h, w, bias_param, bias, mask, row_block: int,
                  v1: dict, ref, device: str = "cuda",
                  timed: bool = True) -> dict:
    """The row-blocked forward at ``row_block`` on the inputs the per-row
    kernel was just held at: the wrapper against the plain versions (the
    per-row one's values ``ref``, within POOL_TOL), m and pos bitwise equal
    to the per-row kernel's (the same walk with ``row_block`` batch rows a
    block), a fully padded row zero, and (timed) the C entry's time beside
    the per-row kernel's and the replaced kernel's. The bound and the
    library yardstick are the per-row kernel's: the same function on the
    same inputs."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import (float_key,
                                                   fused_splade_maxima)
    from splade_tpu_torch.ops.fused_splade_v2 import (
        fused_splade_maxima_v2, fused_splade_pool_v2,
        fused_splade_pool_v2_plain)

    B, S, H = h.shape
    V_ = w.shape[0]
    maskf = mask.float().contiguous()
    with torch.no_grad():
        pooled, tw = fused_splade_pool_v2(h, w, bias_param, mask, row_block)
        m2, pos2 = fused_splade_maxima_v2(h, w, bias, mask, row_block)
        m1, pos1 = fused_splade_maxima(h, w, bias, mask)
        m_p, pos_p = fused_splade_pool_v2_plain(h, w, bias, maskf, row_block)
    if device == "cuda":
        torch.cuda.synchronize()
    ref_pooled, ref_tw = ref
    err = max(float((pooled - ref_pooled).abs().max()),
              float((tw - ref_tw).abs().max()),
              float((pooled - torch.log1p(torch.relu(m_p))).abs().max()),
              float((tw - torch.log1p(torch.relu(pos_p)) * maskf).abs().max()))
    bitwise = bool(torch.equal(m2, m1) and torch.equal(pos2, pos1))
    padded_zero = (float(pooled[-1].abs().max()) == 0.0
                   and float(tw[-1].abs().max()) == 0.0)
    log(f"  pool v2 B={B} S={S} row_block={row_block}: max |err| {err:.3e} "
        f"(tol {POOL_TOL}), m and pos bitwise equal to the per-row "
        f"kernel's: {bitwise}, padded row zero: {padded_zero}")
    if not (err <= POOL_TOL and bitwise and padded_zero):
        raise SystemExit(f"row-blocked pool kernel disagrees (B={B}, S={S}, "
                         f"row_block={row_block})")
    out = dict(shape=v1["shape"], row_block=row_block, max_abs_err=err,
               bitwise_equal_v1=bitwise)
    if not timed:
        return out
    lib = _cuda.library()
    m = torch.empty((B, V_), dtype=torch.float32, device="cuda")
    neg_key = int(float_key(torch.tensor(-1e30)))
    pos_key = torch.full((B, S), neg_key, dtype=torch.int32, device="cuda")

    def kernel():
        pos_key.fill_(neg_key)
        _cuda.check(lib.splade_fused_pool_v2_fwd(
            h.data_ptr(), w.data_ptr(), bias.data_ptr(), maskf.data_ptr(),
            m.data_ptr(), pos_key.data_ptr(), B, S, H, V_, row_block,
            torch.cuda.current_stream().cuda_stream),
            "splade_fused_pool_v2_fwd")

    with torch.no_grad():
        ms = cuda_ms(torch, kernel, iters=20)
        plain_ms = cuda_ms(torch, lambda: fused_splade_pool_v2_plain(
            h, w, bias, maskf, row_block), iters=3, warmup=1)
    replaced = RESIDENT_TILE_FWD_MS.get((B, S, row_block))
    log(f"  pool v2 B={B} S={S} row_block={row_block}: kernel {ms:.4f} ms "
        f"(per-row kernel {v1['ms']:.4f} ms; the resident-tile kernel it "
        f"replaced "
        + (f"{replaced} ms in PERF.md" if replaced else "not measured here")
        + f"), plain {plain_ms:.4f} ms, library {v1['library_ms']:.4f} ms, "
        f"bound {v1['bound_ms']:.4f} ms ({v1['bound_ms'] / ms:.1%} of it)")
    out.update(ms=ms, v1_ms=v1["ms"], plain_ms=plain_ms,
               bound_ms=v1["bound_ms"], bound_by=v1["bound_by"],
               library_ms=v1["library_ms"])
    return out


def check_rescore(torch, enc, rng, syn_terms, syn_vals, B: int = 32,
                  C: int = 1000, M: int = 64, T: int = 64) -> dict:
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.postings_index import (exact_rescore,
                                                     sparse_query_dense)
    from splade_tpu_torch.ops.rescore_kernel import (rescore_match,
                                                     rescore_match_plain,
                                                     rescore_match_rows)

    N, nnz = syn_terms.shape
    # doc-major block as PostingsIndex builds it: pad id V, int8 + scale
    terms = np.full((N, M), V, np.int32)
    terms[:, :nnz] = syn_terms
    scale = (syn_vals.max(1) / 127.0).astype(np.float32)
    q8 = np.zeros((N, M), np.int8)
    q8[:, :nnz] = np.clip(np.round(syn_vals / scale[:, None]), -127, 127)
    d_terms = torch.from_numpy(terms).cuda()
    d_vals = torch.from_numpy(q8).cuda()
    d_scale = torch.from_numpy(scale).cuda()
    q_vecs = enc.encode_queries(hangul_texts(rng, B, 12))
    q_idx = torch.full((B, T), 0, dtype=torch.int32)
    q_val = torch.zeros((B, T), dtype=torch.float32)
    for b, (qi, qv) in enumerate(q_vecs):
        q_idx[b, :len(qi)] = torch.from_numpy(qi[:T])
        q_val[b, :len(qv)] = torch.from_numpy(qv[:T])
    cand = torch.from_numpy(rng.integers(0, N, (B, C)))
    # the last 32 query slots take term j of candidate j (j < 32), so
    # scores are not all zero
    q_idx[:, T - 32:] = torch.from_numpy(
        terms[cand[:, :32].numpy(), np.arange(32)])
    q_idx, q_val, cand = q_idx.cuda(), q_val.cuda(), cand.cuda()
    args = (d_terms, d_vals, d_scale, q_idx, q_val, cand)
    out = rescore_match(*args)
    out_rows = rescore_match_rows(*args)
    ref = exact_rescore(d_terms, d_vals, d_scale,
                        sparse_query_dense(q_idx, q_val, V), cand)
    plain = rescore_match_plain(*args)
    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o in (out, out_rows)
              for r in (ref, plain))
    repeat = bool(torch.equal(out, out_rows))
    log(f"  rescore B={B} C={C} M={M} T={T} N={N}: max |err| {err:.3e} "
        f"(tol {RESCORE_TOL}), nonzero scores {int((ref > 0).sum())}, a "
        f"repeated call bitwise equal: {repeat}")
    if not (err <= RESCORE_TOL and repeat):
        raise SystemExit("rescore kernel disagrees with exact_rescore or "
                         "with itself")
    lib = _cuda.library()
    ci = cand.to(torch.int32)
    res = torch.empty((B, C), dtype=torch.float32, device="cuda")

    def kernel():
        _cuda.check(lib.splade_rescore_match(
            d_terms.data_ptr(), d_vals.data_ptr(), d_scale.data_ptr(),
            q_idx.data_ptr(), q_val.data_ptr(), ci.data_ptr(), res.data_ptr(),
            N, B, C, M, T, torch.cuda.current_stream().cuda_stream),
            "splade_rescore_match")

    ms = graph_ms(torch, kernel, iters=200)
    launched_ms = cuda_ms(torch, kernel, iters=200, warmup=5)
    plain_ms = cuda_ms(torch, lambda: rescore_match_plain(*args), iters=5,
                       warmup=1)
    gather_ms = cuda_ms(torch, lambda: exact_rescore(
        d_terms, d_vals, d_scale, sparse_query_dense(q_idx, q_val, V), cand),
        iters=20, warmup=2)
    moved = B * C * 8 + B * C * M * 5 + B * C * 4 + B * T * 8 + B * C * 4
    # one table lookup and one multiply-add a doc slot of nonzero value
    ops = 2.0 * int((d_vals[cand] != 0).sum())
    bound_ms, bound_by = bound(moved, ops, H100_FP32_OPS)
    log(f"  rescore: kernel {ms:.5f} ms in a CUDA graph, {launched_ms:.5f} "
        f"ms a launch from Python (the scanning kernel it replaced "
        f"{SCAN_RESCORE_MS} ms in PERF.md, timed launch by launch), plain "
        f"match {plain_ms:.4f} ms, "
        f"plain gather (exact_rescore) {gather_ms:.4f} ms, bound "
        f"{bound_ms:.5f} ms ({bound_by}: {moved / 1e6:.2f} MB, "
        f"{ops:.3e} lookups and multiply-adds; {bound_ms / ms:.1%} of it)")
    return dict(shape=f"B={B} C={C} M={M} T={T} N={N}", max_abs_err=err,
                ms=ms, launched_ms=launched_ms, plain_ms=plain_ms,
                gather_ms=gather_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _kernel_route(torch, pool, h, w, bias, mask, gout):
    """Gradients (dh, dw, dbias) of sum(pooled * gout) through ``pool``'s
    autograd.Function on the card: forward kernel -> backward kernels, on
    f32 copies of the values (so the gradients come back in f32)."""
    leaves = [t.float().clone().requires_grad_() for t in (h, w, bias)]
    pooled, _ = pool(*leaves, mask)
    (pooled * gout).sum().backward()
    return [t.grad for t in leaves]


def _plain_route(torch, h, w, bias, mask, gout):
    """The same gradients from the plain forward and the plain backward."""
    from splade_tpu_torch.ops.fused_splade import (fold_cotangent,
                                                   fused_splade_bwd_plain,
                                                   fused_splade_pool_plain)

    with torch.no_grad():
        hf, wf, bf = (t.float() for t in (h, w, bias))
        m, _ = fused_splade_pool_plain(hf, wf, bf, mask)
        g_pre = fold_cotangent(gout, m)
        dh, dw = fused_splade_bwd_plain(hf, wf, bf, mask, m, g_pre)
    return [dh, dw, g_pre.sum(0)]


def recompute_check(torch, h, w, bias, mask, m, dh1) -> dict:
    """Check (c): ``dh1`` is the dh kernel's output for the forward
    kernel's maxima ``m`` and g_pre = 1 on every row with a valid position
    (0 on a padded row, as ``fold_cotangent`` makes it there). Each column
    of a valid row sends its W row to every position whose recomputed
    score equals m, so
    ``sum_s dh1[b] - sum_v W[v]`` must be a whole, non-negative count of
    W rows of columns where the row has a tie. Tie candidates come from f32
    scores (positions within RECOMPUTE_TIE_RTOL of the column's best);
    their counts are fitted by least squares, and what remains must be
    within RECOMPUTE_RTOL of |sum_v W[v]| in every valid row. A recompute
    that misses m loses a W row (a count of -1), one that matches elsewhere
    adds one the candidates cannot explain. Padded rows must be zero."""
    hf, wf = h.float(), w.float()
    bf = bias.float() if bias is not None else torch.zeros_like(wf[:, 0])
    valid = mask > 0
    rows = valid.any(1)
    want = wf.sum(0)
    scale = float(want.norm())
    resid = (dh1.float().sum(1) - want).double().cpu()
    raw = resid.norm(dim=1) / scale
    worst, ties, tied_rows, counts_ok = 0.0, 0, 0, True
    share = []  # the most columns one position of a row holds the maximum of
    for b in torch.nonzero(rows).flatten().tolist():
        s = hf[b][valid[b]] @ wf.T + bf
        best = s.amax(0)
        share.append(float(torch.bincount(s.argmax(0)).max()) / s.shape[1])
        near = s >= best - RECOMPUTE_TIE_RTOL * best.abs().clamp_min(1.0)
        extra = near.sum(0) - 1  # the most extra matches a column can hold
        cand = torch.nonzero(extra > 0).flatten()
        r = resid[b]
        if 0 < cand.numel() < wf.shape[1]:
            A = wf[cand].double().cpu().T
            fit = torch.linalg.lstsq(A, r[:, None]).solution[:, 0]
            n = fit.round()
            counts_ok &= bool((fit - n).abs().max() <= 0.1 and (n >= 0).all()
                              and (n <= extra[cand].cpu()).all())
            r = r - A @ n
            ties += int(n.sum())
            tied_rows += int(n.sum() > 0)
        elif cand.numel():
            counts_ok = False                         # more candidates than H
        worst = max(worst, float(r.norm()) / scale)
    padded_zero = float(dh1[~rows].abs().sum()) == 0.0
    return dict(rows=int(rows.sum()), tied_rows=tied_rows, ties=ties,
                worst_before_ties=float(raw[rows.cpu()].max()) if rows.any()
                else 0.0, worst=worst, counts_ok=counts_ok,
                padded_zero=padded_zero,
                top_position_share=dict(mean=float(np.mean(share)),
                                        max=float(np.max(share)))
                if share else None,
                ok=counts_ok and padded_zero and worst <= RECOMPUTE_RTOL)


def pool_families() -> dict:
    """name -> its public pool function, its forward and dh wrappers and
    its row_block (None for the per-row family): the per-row family and the
    row-blocked one at each of V2_ROW_BLOCKS."""
    from splade_tpu_torch.ops.fused_splade import (fused_splade_bwd_dh,
                                                   fused_splade_maxima,
                                                   fused_splade_pool)
    from splade_tpu_torch.ops.fused_splade_v2 import (fused_splade_bwd_dh_v2,
                                                      fused_splade_maxima_v2,
                                                      fused_splade_pool_v2)

    fams = {"v1": dict(pool=fused_splade_pool, maxima=fused_splade_maxima,
                       dh=fused_splade_bwd_dh, row_block=None)}
    for rb in V2_ROW_BLOCKS:
        fams[f"v2 rb={rb}"] = dict(
            pool=lambda *a, rb=rb: fused_splade_pool_v2(*a, rb),
            maxima=lambda *a, rb=rb: fused_splade_maxima_v2(*a, rb),
            dh=lambda *a, rb=rb: fused_splade_bwd_dh_v2(*a, rb),
            row_block=rb)
    return fams


def match_bit_counts(torch, match, S: int):
    """Per (b, v) column, the bits of the bitmask [B, J, V] (int32): the
    positions the match pass found."""
    counts = torch.zeros(match.shape, dtype=torch.int32, device=match.device)
    for r in range(32):
        counts += (match >> r) & 1
    return counts.sum(1)


def match_check(torch, h, w, bias, mask, m, g_pre, exact: bool,
                row_block=None) -> dict:
    """A match pass on its own, through its wrapper: the per-row family's
    (``row_block`` None) or the row-blocked family's at ``row_block``. With
    the forward kernel's maxima m every column of a valid row whose g is
    not 0 must hold at least one bit (the recompute reaches the forward's
    maximum bit for bit; one ulp off, it would find almost none), and no
    bit may stand on an invalid position, a position past S or a g = 0
    column. On exact inputs (every score exact in f32 in any order) the
    bitmask must equal the plain match's bit for bit, every exact tie
    included. The row-blocked bitmask must equal the per-row match pass's
    bit for bit on any inputs: both keep the same products."""
    from splade_tpu_torch.ops.fused_splade import (fused_splade_bwd_match,
                                                   fused_splade_bwd_match_plain)
    from splade_tpu_torch.ops.fused_splade_v2 import fused_splade_bwd_match_v2

    B, S = mask.shape
    got = (fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
           if row_block is None else
           fused_splade_bwd_match_v2(h, w, bias, mask, m, g_pre, row_block))
    counts = match_bit_counts(torch, got, S)
    live = (g_pre != 0) & (mask.sum(1, keepdim=True) > 0)
    # a word whose bits are the invalid positions (and those past S)
    pos = torch.arange(got.shape[1] * 32, device=mask.device)
    invalid = torch.ones((B, got.shape[1] * 32), dtype=torch.int64,
                         device=mask.device)
    invalid[:, :S] = (mask == 0).long()
    inv_words = (invalid.view(B, -1, 32) << (pos[:32].long())).sum(2)
    inv_words = torch.where(inv_words >= 2 ** 31, inv_words - 2 ** 32,
                            inv_words).to(torch.int32)
    out = dict(
        columns=int(live.sum()),
        found=bool((counts[live] >= 1).all()),
        stray=int((got & inv_words[:, :, None]).ne(0).sum())
        + int(counts[~live].sum()),
        ties=int((counts - 1).clamp_min(0).sum()))
    if exact:
        want = fused_splade_bwd_match_plain(h.float(), w.float(), bias, mask,
                                            m, g_pre)
        out["bits_differing"] = int(match_bit_counts(
            torch, got ^ want, S).sum())
        del want
    if row_block is not None:
        per_row = fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
        out["bits_differing_per_row"] = int(match_bit_counts(
            torch, got ^ per_row, S).sum())
        del per_row
    out["ok"] = (out["found"] and out["stray"] == 0
                 and out.get("bits_differing", 0) == 0
                 and out.get("bits_differing_per_row", 0) == 0)
    return out


def check_pool_backward(torch, model, tok, rng, B: int, S: int) -> dict:
    """The kernels of both families at one training shape (the shapes the
    training path and the row-blocked pool's path launch them at), held
    against the plain versions. Forward: each family's maxima wrapper
    against the plain forward, as pooled values and token weights within
    POOL_TOL. Backward: (a) small-integer inputs, where every score
    is exact in f32 in any order and exact ties are common, elementwise;
    (b) the model's own states, by norm (near-ties may pick another
    argmax); (c) with g_pre = 1 the dh kernels must send each column's W row
    to the per-row forward kernel's argmax; a repeated backward of every
    family must be bitwise equal, and the row-blocked forward's maxima the
    per-row kernel's. Every family's match pass is also held alone
    (``match_check``: bitwise the plain bitmask on (a), every maximum found
    on (b), the row-blocked bitmask bitwise the per-row one on both). Then
    the times of all kernels on the same inputs: each family's match pass,
    dh gather and dW gather apart, each gradient's kernels together and the
    whole backward, the plain backward, a cuBLAS composition and the bound.
    Returns {family: {"match": ..., "dh": ..., "dw": ...}}."""
    from splade_tpu_torch.ops.fused_splade import (PER_ROW, _bwd_operands,
                                                   fold_cotangent,
                                                   fused_splade_bwd_match_plain,
                                                   fused_splade_bwd_plain,
                                                   fused_splade_maxima,
                                                   fused_splade_pool_plain,
                                                   launch_gather,
                                                   launch_match,
                                                   launch_match_gather,
                                                   match_words)
    from splade_tpu_torch.ops.fused_splade_v2 import (
        ROW_BLOCKED, fused_splade_bwd_match_v2_plain, fused_splade_bwd_v2_plain)

    enc = tok(hangul_texts(rng, B, S), max_length=S)
    ids = torch.from_numpy(enc["input_ids"]).cuda()
    mask = torch.from_numpy(enc["attention_mask"]).cuda()
    lens = torch.from_numpy(rng.integers(1, S + 1, B)).cuda()
    mask = mask * (torch.arange(S, device="cuda")[None] < lens[:, None])
    mask[-1] = 0                                  # a fully padded row
    with torch.no_grad():
        h = model.mlm.head_transform(model.mlm.encode(ids, mask)).contiguous()
    w, bias_p = model.mlm.decoder_weights()
    w, bias = w.detach(), bias_p.detach().float().contiguous()
    H = h.shape[-1]
    gen = torch.Generator(device="cuda").manual_seed(B * S)
    gout = torch.randn((B, V), device="cuda", generator=gen)
    names = ("dh", "dw", "dbias")
    families = pool_families()

    # (a) exactly representable inputs, (b) the model's states: the plain
    # route once, every family's kernel route against it, twice
    ints = lambda *shape: torch.randint(-2, 3, shape, device="cuda",
                                        generator=gen).float()
    exact = (ints(B, S, H), ints(V, H), ints(V))
    checks = {name: {} for name in families}
    for label, inputs in (("a", exact), ("b", (h, w, bias))):
        want = _plain_route(torch, *inputs, mask, gout)
        for name, fam in families.items():
            got = _kernel_route(torch, fam["pool"], *inputs, mask, gout)
            c = checks[name]
            if label == "a":
                c["abs_a"] = {n: float((g - r).abs().max())
                              for n, g, r in zip(names, got, want)}
                c["err_a"] = {n: c["abs_a"][n] / float(r.abs().max())
                              for n, r in zip(names, want)}
                c["finite"] = all(bool(torch.isfinite(g).all()) for g in got)
                c["padded_zero"] = float(got[0][-1].abs().max()) == 0.0
            else:
                c["err_b"] = {n: float((g - r).norm() / r.norm())
                              for n, g, r in zip(names, got, want)}
                c["padded_zero"] &= float(got[0][-1].abs().max()) == 0.0
            # no float atomics in any family: a repeated backward is bitwise
            again = _kernel_route(torch, fam["pool"], *inputs, mask, gout)
            c["repeat_bitwise"] = c.get("repeat_bitwise", True) and all(
                bool(torch.equal(x, y)) for x, y in zip(got, again))
            del got, again
        del want
        with torch.no_grad():  # every family's match pass alone
            m_in, _ = fused_splade_maxima(*inputs, mask)
            g_in = fold_cotangent(gout, m_in)
            for name, fam in families.items():
                checks[name][f"match_{label}"] = match_check(
                    torch, *inputs, mask, m_in, g_in, exact=label == "a",
                    row_block=fam["row_block"])
        del m_in, g_in
    del exact
    # the forward at this shape: every family's maxima against the plain
    # forward. (c) every family's recompute equals the per-row forward
    # kernel's maxima, which the row-blocked forward's must equal bit for bit
    maskf = mask.float().contiguous()
    hf, wf = h.float(), w.float()
    with torch.no_grad():
        m_p, pos_p = fused_splade_pool_plain(hf, wf, bias, maskf)
        want_fwd = (torch.log1p(torch.relu(m_p)),
                    torch.log1p(torch.relu(pos_p)) * maskf)
        m_k, _ = fused_splade_maxima(h, w, bias, mask)
        ones = (mask.sum(1, keepdim=True) > 0).float().expand_as(m_k)
        for name, fam in families.items():
            m_f, pos_f = fam["maxima"](h, w, bias, mask)
            got_fwd = (torch.log1p(torch.relu(m_f)),
                       torch.log1p(torch.relu(pos_f)) * maskf)
            checks[name]["err_fwd"] = max(
                float((g - r).abs().max()) for g, r in zip(got_fwd, want_fwd))
            if fam["row_block"] is not None:
                checks[name]["m_bitwise"] = bool(torch.equal(m_f, m_k))
            del m_f, pos_f, got_fwd
            dh1 = fam["dh"](h, w, bias, mask, m_k, ones)
            checks[name]["rc"] = recompute_check(torch, h, w, bias, mask,
                                                 m_k, dh1)
            del dh1
        del want_fwd, pos_p
    for name, c in checks.items():
        rc = c["rc"]
        share = rc["top_position_share"]
        matches = [c[k] for k in ("match_a", "match_b")]
        log(f"  pool backward {name} B={B} S={S}: forward vs plain max |err| "
            f"{c['err_fwd']:.3e} (tol {POOL_TOL}); (a) exact inputs max err "
            + ", ".join(f"{n} {e:.2e}" for n, e in c["err_a"].items())
            + f" (tol {BWD_EXACT_RTOL} of each tensor's largest value); (b) "
            "model states norm err " + ", ".join(
                f"{n} {e:.2e}" for n, e in c["err_b"].items())
            + f" (tol {BWD_NORM_RTOL}); (c) recompute over {rc['rows']} "
            f"rows: {rc['ties']} exact ties in {rc['tied_rows']} rows "
            f"(counts sound: {rc['counts_ok']}), worst row "
            f"{rc['worst_before_ties']:.2e} before and {rc['worst']:.2e} "
            f"after the ties (tol {RECOMPUTE_RTOL}); padded row zero and "
            f"finite: {c['padded_zero'] and c['finite']}; repeated backward "
            f"bitwise equal: {c['repeat_bitwise']}"
            + (f", forward maxima bitwise the per-row kernel's: "
               f"{c['m_bitwise']}" if "m_bitwise" in c else
               f"; the position holding most of a row's maxima holds "
               f"{share['mean']:.1%} of the columns on average, "
               f"{share['max']:.1%} at most")
            + "".join(
                f"; match pass ({k}): {x['columns']} live columns, every "
                f"maximum found: {x['found']}, stray bits {x['stray']}, "
                f"{x['ties']} extra bits (ties)"
                + (f", bits differing from the plain bitmask "
                   f"{x['bits_differing']}" if "bits_differing" in x else "")
                + (f", from the per-row match pass's "
                   f"{x['bits_differing_per_row']}"
                   if "bits_differing_per_row" in x else "")
                for k, x in zip(("a", "b"), matches)))
        if not (c["err_fwd"] <= POOL_TOL
                and max(c["err_a"].values()) <= BWD_EXACT_RTOL
                and max(c["err_b"].values()) <= BWD_NORM_RTOL
                and rc["ok"] and c["padded_zero"] and c["finite"]
                and c["repeat_bitwise"] and c.get("m_bitwise", True)
                and all(x["ok"] for x in matches)):
            raise SystemExit(f"fused pool backward kernels ({name}) disagree "
                             f"(B={B}, S={S})")

    # times on prepared operands, with the forward kernel's maxima and with
    # maxima no score reaches (the recompute alone), the forward kernel
    # beside them: each family's match pass, each gather from its bitmask,
    # each gradient's kernels together and the whole backward
    g_pre = fold_cotangent(gout, m_k).contiguous()
    never = torch.full_like(m_k, float("inf"))
    g_p = fold_cotangent(gout, m_p)
    valid = maskf > 0

    def library(which):
        # timing yardstick only: bf16 cuBLAS logits, eq/where, bf16 GEMM
        logits = torch.matmul(h.view(B * S, H), w.T).view(B, S, V)
        eq = (logits.float() + bias == m_k[:, None, :]) & valid[:, :, None]
        G = torch.where(eq, g_pre[:, None, :], 0.0).to(torch.bfloat16)
        if which == "dh":
            return torch.matmul(G, w)
        return torch.matmul(G.view(B * S, V).T, h.view(B * S, H))

    def family_times(fam, ext) -> dict:
        bits = launch_match(fam, ops, ext)
        gather = lambda which: launch_gather(
            fam, which, bits, ops.wb if which == "dh" else ops.hb, ops.g, S)
        t = dict(
            match_ms=cuda_ms(torch, lambda: launch_match(fam, ops, ext),
                             iters=5, warmup=1),
            match_no_match_ms=cuda_ms(
                torch, lambda: launch_match(fam, ops_never, ext), iters=3,
                warmup=1),
            backward_ms=cuda_ms(torch, lambda: launch_match_gather(
                fam, ops, ext, ("dh", "dw")), iters=5, warmup=1),
            splits=list(fam.dh_splits(B, S, H, V)))
        for which in ("dh", "dw"):
            t[which] = dict(
                gather_ms=cuda_ms(torch, lambda: gather(which), iters=5,
                                  warmup=1),
                ms=cuda_ms(torch, lambda: launch_match_gather(
                    fam, ops, ext, (which,)), iters=5, warmup=1),
                no_match_ms=cuda_ms(torch, lambda: launch_match_gather(
                    fam, ops_never, ext, (which,)), iters=3, warmup=1))
        return t

    with torch.no_grad():
        library_ms = {which: cuda_ms(torch, lambda: library(which), iters=3,
                                     warmup=1) for which in ("dh", "dw")}
        fwd_ms = cuda_ms(torch, lambda: fused_splade_maxima(h, w, bias, mask),
                         iters=5, warmup=1)
        ops = _bwd_operands(h, w, bias, mask, m_k, g_pre)
        ops_never = _bwd_operands(h, w, bias, mask, never, g_pre)
        times = {"v1": dict(family_times(PER_ROW, []), forward_ms=fwd_ms)}
        plain_ms = {None: cuda_ms(torch, lambda: fused_splade_bwd_plain(
            hf, wf, bias, maskf, m_p, g_p), iters=2, warmup=1)}
        match_plain_ms = {None: cuda_ms(
            torch, lambda: fused_splade_bwd_match_plain(
                hf, wf, bias, maskf, m_p, g_p), iters=2, warmup=1)}
        for name, fam in families.items():
            rb = fam["row_block"]
            if rb is None:
                continue
            times[name] = family_times(ROW_BLOCKED, [rb])
            # the family's own forward wrapper at this shape
            times[name]["forward_ms"] = cuda_ms(
                torch, lambda: fam["maxima"](h, w, bias, mask), iters=5,
                warmup=1)
            plain_ms[rb] = cuda_ms(
                torch, lambda: fused_splade_bwd_v2_plain(
                    hf, wf, bias, maskf, m_p, g_p, rb), iters=2, warmup=1)
            match_plain_ms[rb] = cuda_ms(
                torch, lambda: fused_splade_bwd_match_v2_plain(
                    hf, wf, bias, maskf, m_p, g_p, rb), iters=2, warmup=1)
        del ops_never
    nvalid = float(maskf.sum())
    matches = float((g_pre != 0).sum())  # one a (b, v), ties aside
    # the function's own work: the recompute, 2*valid*H*V bf16 operations
    # on the tensor cores, plus one f32 row of H multiply-adds a match on
    # the CUDA cores (their times added); bytes: inputs once, output once.
    # Beside it, the TPU kernels' convention: the recompute plus a dense
    # G @ W (or G^T @ h) contraction, 4*valid*H*V bf16 operations
    recompute_ops = 2.0 * nvalid * H * V
    add_ops = 2.0 * matches * H
    ops_ms = (recompute_ops / H100_BF16_FLOPS + add_ops / H100_FP32_OPS) * 1e3
    shared = h.numel() * 2 + w.numel() * 2 + V * 4 + B * S * 4 + 2 * B * V * 4
    # the match pass alone: its function is the bitmask, bound by the
    # recompute (bytes: inputs once, the bitmask written once)
    mb = match_words(S) * B * V * 4
    m_bound, m_by = bound(shared + mb, recompute_ops, H100_BF16_FLOPS)
    result = {name: {} for name in families}
    for which, out_bytes in (("dh", B * S * H * 4), ("dw", V * H * 4)):
        bytes_ms = (shared + out_bytes) / H100_BYTES * 1e3
        bound_ms, bound_by = ((ops_ms, "operations") if ops_ms >= bytes_ms
                              else (bytes_ms, "bytes"))
        dense_ms = bound(shared + out_bytes, 2 * recompute_ops,
                         H100_BF16_FLOPS)[0]
        for name, fam in families.items():
            c, tf = checks[name], times[name]
            t = tf[which]
            rb = fam["row_block"]
            result[name][which] = dict(
                shape=f"B={B} S={S} H={H} V={V}", row_block=rb,
                max_abs_err=c["abs_a"][which],  # (a): kernel vs plain route
                forward_max_abs_err=c["err_fwd"],
                err_exact=c["err_a"][which], err_norm=c["err_b"][which],
                recompute=c["rc"], repeat_bitwise=c["repeat_bitwise"],
                ms=t["ms"], ms_is=f"the match pass and the {which} gather",
                gather_ms=t["gather_ms"], match_ms=tf["match_ms"],
                backward_ms=tf["backward_ms"], no_match_ms=t["no_match_ms"],
                no_match_is="the match pass and the gather with maxima no "
                            "score reaches",
                v1_ms=times["v1"][which]["ms"], dh_splits=tf["splits"],
                forward_ms=fwd_ms, family_forward_ms=tf["forward_ms"],
                plain_ms=plain_ms[rb], plain_computes="dh and dw together",
                library_ms=library_ms[which], bound_ms=bound_ms,
                bound_by=bound_by, matches=matches,
                bound_dense_contraction_ms=dense_ms)
            # PERF.md's times go to the log only: the kernels line holds
            # this run's measurements
            before = RECOMPUTE_KERNELS_MS.get((B, S, rb))
            log(f"  pool backward {name} {which} B={B} S={S}: kernels "
                f"{t['ms']:.3f} ms (match pass {tf['match_ms']:.3f} + "
                f"{which} gather {t['gather_ms']:.3f}; the whole backward "
                f"{tf['backward_ms']:.3f})"
                + (f" [the recomputing kernel it replaced: {before[which]} "
                   "ms, PERF.md]" if before else "")
                + f" ({t['no_match_ms']:.3f} ms with maxima nothing reaches; "
                f"forward at this shape {tf['forward_ms']:.3f} ms, "
                f"per-row {fwd_ms:.3f}), plain (dh+dw) "
                f"{plain_ms[rb]:.3f} ms, library "
                f"{library_ms[which]:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}: {recompute_ops:.3e} bf16 FLOP over "
                f"{nvalid:.0f} valid tokens + {add_ops:.3e} f32 FLOP over "
                f"{matches:.0f} matches; dense-contraction convention "
                f"{dense_ms:.3f} ms)")
    for name, fam in families.items():
        rb, tf = fam["row_block"], times[name]
        ca, cb = checks[name]["match_a"], checks[name]["match_b"]
        differ = (ca["bits_differing"] + ca.get("bits_differing_per_row", 0)
                  + cb.get("bits_differing_per_row", 0))
        result[name]["match"] = dict(
            shape=f"B={B} S={S} H={H} V={V}", row_block=rb,
            max_abs_err=float(differ > 0),
            bits_differing_exact=ca["bits_differing"],
            bits_differing_per_row=(None if rb is None else
                                    {"a": ca["bits_differing_per_row"],
                                     "b": cb["bits_differing_per_row"]}),
            checks={"match_a": ca, "match_b": cb},
            ms=tf["match_ms"], no_match_ms=tf["match_no_match_ms"],
            v1_ms=times["v1"]["match_ms"], plain_ms=match_plain_ms[rb],
            bound_ms=m_bound, bound_by=m_by, library_ms=None,
            forward_ms=fwd_ms, bitmask_mb=mb / 1e6)
        log(f"  pool backward {name} match pass B={B} S={S}: "
            f"{tf['match_ms']:.3f} ms ({tf['match_no_match_ms']:.3f} with "
            f"maxima nothing reaches; the per-row forward {fwd_ms:.3f}, the "
            f"per-row match pass {times['v1']['match_ms']:.3f}), plain "
            f"{match_plain_ms[rb]:.3f} ms, bound {m_bound:.3f} ms ({m_by}), "
            f"bitmask {mb / 1e6:.1f} MB; dh gather "
            f"{tf['dh']['gather_ms']:.3f} ms (hidden slices, vocab splits "
            f"{tf['splits']}), dW gather {tf['dw']['gather_ms']:.3f} ms")
    return result


def splash_case(torch, rng, B: int, S: int, N: int, D: int, packed: bool,
                device: str = "cuda"):
    """Operands as the encoder hands them to the attention: q and k fresh
    from RoPE ([B, S, N, D] storage seen as [B, N, S, D]), v a strided view
    of the fused QKV product, a seeded dO; bf16 on the card. Rows have
    random lengths, row 0 is all padding; with ``packed`` the last B // 9
    rows hold 4 packed segments of S // 4 with a length each (0 included),
    as the V33 micro-batch's query rows do. Returns (q, k, v, seg, d_out,
    allowed [B, S, S] per window)."""
    from splade_tpu_torch.ops.splash_attention import segment_ids_with_padding

    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 31)))
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    randn = lambda *shape: torch.randn(shape, device=device,
                                       generator=gen).to(dtype)
    q = randn(B, S, N, D).transpose(1, 2)
    k = randn(B, S, N, D).transpose(1, 2)
    v = randn(B, S, 3, N, D)[:, :, 2].transpose(1, 2)
    d_out = randn(B, S, N, D)
    pos = np.arange(S)[None]
    lens = rng.integers(1, S + 1, (B, 1))
    lens[0] = 0
    mask = pos < lens
    segs = np.zeros((B, S), np.int64)
    if packed:
        rows, width = max(B // 9, 1), S // 4
        segs[B - rows:] = np.minimum(pos // width, 3)
        seg_lens = rng.integers(0, width + 1, (rows, 4))
        mask[B - rows:] = (pos % width) < np.take_along_axis(
            seg_lens, segs[B - rows:], 1)
    seg = segment_ids_with_padding(
        torch.from_numpy(mask.astype(np.int64)).to(device),
        torch.from_numpy(segs).to(device))
    return q, k, v, seg, d_out


def splash_allowed(torch, seg, half_window: int):
    """[B, S, S] bool: the pairs the attention's mask allows."""
    S = seg.shape[1]
    ok = seg[:, :, None] == seg[:, None, :]
    if half_window > 0:
        idx = torch.arange(S, device=seg.device)
        ok = ok & ((idx[:, None] - idx[None, :]).abs() <= half_window)
    return ok


def check_splash(torch, rng, B: int, S: int, half_window: int, packed: bool,
                 N: int = SPLASH_HEADS, D: int = SPLASH_HEAD_DIM,
                 device: str = "cuda", timed: bool = True) -> dict:
    """The three splash attention kernels against their plain versions at
    one shape and window: the forward's out and lse; for a seeded dO, the dq
    kernel's delta against the plain reduction, and dq, dk, dv against the
    plain backward fed the forward kernel's lse and the plain delta; the
    gradients that come back through ``splash_attention``'s
    autograd.Function equal to the wrappers' own, and a repeated backward
    bitwise equal. Then times by CUDA events, with the gradients in the
    dtypes the training paths give them (q and k come out of RoPE in f32
    under autocast, v in bf16: dq and dk f32, dv bf16): each kernel, the
    dq kernel computing delta alone, the whole backward as the Function
    runs it, the plain versions', one ``scaled_dot_product_attention`` call
    with the same boolean mask as the library yardstick (forward, and its
    backward for dq, dk and dv together), and the bound from this run's
    allowed pairs. Returns {"fwd": ..., "dq": ..., "dkv": ...}."""
    from splade_tpu_torch.ops import splash_attention as sa

    q, k, v, seg, d_out = splash_case(torch, rng, B, S, N, D, packed, device)
    hw = half_window
    with torch.no_grad():
        out, lse = sa.splash_attention_forward(q, k, v, seg, hw)
        out_p, lse_p = sa.splash_attention_plain(q, k, v, seg, hw)
        dq, delta = sa.splash_attention_bwd_dq(q, k, v, seg, hw, d_out, out,
                                               lse)
        dk, dv = sa.splash_attention_bwd_dkv(q, k, v, seg, hw, d_out, lse,
                                             delta)
        delta_p = sa.splash_attention_delta(d_out, out)
        dq_p, dk_p, dv_p = sa.splash_attention_bwd_plain(
            q, k, v, seg, hw, d_out, lse, delta_p)
    # through autograd: the Function's gradients are the wrappers' own
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    got = sa.splash_attention(*leaves, seg, hw)
    grads = torch.autograd.grad(got, leaves, d_out, retain_graph=True)
    again = torch.autograd.grad(got, leaves, d_out)
    if device == "cuda":
        torch.cuda.synchronize()
    wired = (bool(torch.equal(got.detach(), out.to(got.dtype)))
             and all(bool(torch.equal(g, d.transpose(1, 2).to(g.dtype)))
                     for g, d in zip(grads, (dq, dk, dv))))
    repeat_bitwise = all(bool(torch.equal(a, b))
                         for a, b in zip(grads, again))
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp_min(1e-30))
    err = dict(out=rel(out, out_p), dq=rel(dq, dq_p), dk=rel(dk, dk_p),
               dv=rel(dv, dv_p))
    delta_err = rel(delta, delta_p)
    absolute = dict(fwd=float((out.float() - out_p).abs().max()),
                    dq=float((dq - dq_p).abs().max()),
                    dkv=max(float((dk - dk_p).abs().max()),
                            float((dv - dv_p).abs().max())))
    relative = dict(fwd=err["out"], dq=err["dq"],
                    dkv=max(err["dk"], err["dv"]))
    lse_err = float((lse - lse_p).abs().max())
    finite = all(bool(torch.isfinite(t).all())
                 for t in (out, lse, delta, dq, dk, dv))
    allowed = splash_allowed(torch, seg, hw)
    pairs = float(allowed.sum())
    label = (f"splash B={B} S={S} N={N} D={D} half_window={hw}"
             f"{' packed' if packed else ''}")
    log(f"  {label}: forward out {err['out']:.2e} of its largest value, lse "
        f"{lse_err:.2e} (tol {SPLASH_RTOL:.2e} / {SPLASH_LSE_ATOL}); backward "
        f"delta {delta_err:.2e} (tol {SPLASH_DELTA_RTOL:.0e}), dq "
        f"{err['dq']:.2e} dk {err['dk']:.2e} dv {err['dv']:.2e} (tol "
        f"{SPLASH_RTOL:.2e}); finite: {finite}; autograd returns the "
        f"wrappers' values: {wired}; repeated backward bitwise equal: "
        f"{repeat_bitwise}; {pairs / (B * S):.1f} allowed keys a query")
    if not (max(err.values()) <= SPLASH_RTOL and lse_err <= SPLASH_LSE_ATOL
            and delta_err <= SPLASH_DELTA_RTOL and finite and wired
            and repeat_bitwise):
        raise SystemExit(f"splash attention kernels disagree ({label})")
    shape = dict(shape=f"B={B} S={S} N={N} D={D}", half_window=hw,
                 packed=packed, allowed_pairs=pairs)
    result = {name: dict(shape, max_abs_err=absolute[name],
                         max_rel_err=relative[name])
              for name in ("fwd", "dq", "dkv")}
    result["fwd"]["lse_max_abs_err"] = lse_err
    result["dq"]["delta_max_rel_err"] = delta_err
    if not timed:
        return result

    import torch.nn.functional as F
    lib_mask = allowed[:, None]
    f32, bf16 = torch.float32, torch.bfloat16

    def library_grads():
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=lib_mask)
        return torch.autograd.grad(o, (ql, kl, vl), d_out.transpose(1, 2))

    def whole_backward():  # as _SplashAttention.backward runs it
        _, dl = sa.splash_attention_bwd_dq(q, k, v, seg, hw, d_out, out, lse,
                                           f32)
        sa.splash_attention_bwd_dkv(q, k, v, seg, hw, d_out, lse, dl, f32,
                                    bf16)

    with torch.no_grad():
        ms = dict(
            fwd=cuda_ms(torch, lambda: sa.splash_attention_forward(
                q, k, v, seg, hw), iters=20),
            dq=cuda_ms(torch, lambda: sa.splash_attention_bwd_dq(
                q, k, v, seg, hw, d_out, out, lse, f32), iters=20),
            dkv=cuda_ms(torch, lambda: sa.splash_attention_bwd_dkv(
                q, k, v, seg, hw, d_out, lse, delta, f32, bf16), iters=20))
        delta_only_ms = cuda_ms(torch, lambda: sa.splash_attention_bwd_dq(
            q, k, v, seg, hw, d_out, out, lse, None), iters=20)
        whole_ms = cuda_ms(torch, whole_backward, iters=20)
        plain_fwd = cuda_ms(torch, lambda: sa.splash_attention_plain(
            q, k, v, seg, hw), iters=2, warmup=1)
        plain_bwd = cuda_ms(torch, lambda: sa.splash_attention_bwd_plain(
            q, k, v, seg, hw, d_out, lse, delta_p), iters=2, warmup=1)
        lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask), iters=5, warmup=1)
    lib_both = cuda_ms(torch, library_grads, iters=5, warmup=1)
    lib_bwd = max(lib_both - lib_fwd, 0.0)
    tensor = B * S * N * D  # elements of q, k, v, out, dO, dq, dk or dv
    row = B * N * S * 4     # bytes of lse or delta
    seg_bytes = B * S * 4
    work = dict(  # (bytes: inputs once, outputs once; bf16 operations)
        fwd=(4 * tensor * 2 + row + seg_bytes, 4.0 * D * pairs * N),
        # q, k, v, dO, out, lse, seg in; dq (f32) and delta out
        dq=(5 * tensor * 2 + row + seg_bytes + tensor * 4 + row,
            6.0 * D * pairs * N),
        # q, k, v, dO, lse, delta, seg in; dk (f32) and dv (bf16) out
        dkv=(4 * tensor * 2 + 2 * row + seg_bytes + tensor * (4 + 2),
             8.0 * D * pairs * N))
    for name in ("fwd", "dq", "dkv"):
        moved, ops = work[name]
        bound_ms, bound_by = bound(moved, ops, H100_BF16_FLOPS)
        result[name].update(
            ms=ms[name], plain_ms=plain_fwd if name == "fwd" else plain_bwd,
            library_ms=lib_fwd if name == "fwd" else lib_bwd,
            bound_ms=bound_ms, bound_by=bound_by, bytes_moved=moved, ops=ops)
        if name != "fwd":
            result[name].update(
                grad_dtypes="dq f32, dk f32, dv bf16",
                plain_computes="dq, dk and dv together",
                library_computes="dq, dk and dv together (the call's "
                                 "backward: forward + backward minus forward)",
                whole_backward_ms=whole_ms,
                whole_over_library=whole_ms / lib_bwd if lib_bwd else None,
                delta_only_ms=delta_only_ms)
        log(f"  {label} {name}: kernel {ms[name]:.4f} ms, plain "
            f"{result[name]['plain_ms']:.3f} ms, library "
            f"{result[name]['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {moved / 1e6:.1f} MB, {ops:.3e} FLOP)"
            + (f"; the dq kernel for delta alone {delta_only_ms:.4f} ms"
               if name == "dq" else ""))
    log(f"  {label} whole backward (dq kernel with delta, then dk/dv): "
        f"{whole_ms:.4f} ms against the library's {lib_bwd:.4f} ms ("
        + (f"{whole_ms / lib_bwd:.2f}x" if lib_bwd else "library not timed")
        + ")")
    return result


# ------------------------------------------------------------ phase 3
def _http(addr, method, path, payload=None):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    body = json.dumps(payload).encode() if payload is not None else None
    t0 = time.perf_counter()
    conn.request(method, path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = json.loads(resp.read())
    dt = time.perf_counter() - t0
    conn.close()
    if resp.status != 200:
        raise SystemExit(f"{method} {path} -> {resp.status}: {out}")
    return out, dt


def drive(name: str, engine, model, queries, doc_text: str) -> dict:
    """Serve ``engine`` over HTTP and send the request mix: batched
    /search at k=10 and k=100 (held against the plain path), single-query
    /search from 8 concurrent clients (timed), /encode, /index and a
    /search that must find the new document. Returns latency stats."""
    from splade_tpu_torch.ops.fused_splade import fused_splade_pool
    from splade_tpu_torch.ops.rescore_kernel import rescore_match
    from splade_tpu_torch.serving.server import SearchService, create_server

    service = SearchService(engine, max_batch_size=32, max_wait_ms=5.0,
                            warmup=True)
    server = create_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address[:2]
    lat = []
    try:
        health, _ = _http(addr, "GET", "/healthz")
        assert health["docs"] == engine.num_docs, health
        served = {}
        for k in (10, 100):
            out, dt = _http(addr, "POST", "/search",
                            {"queries": queries, "k": k})
            served[k] = [[(r["doc_id"], r["score"]) for r in rs]
                         for rs in out["results"]]
            assert all(0 < len(r) <= k for r in served[k]), name
        compare_with_plain_path(name, engine, model, queries, served)
        compare_search_vector(name, engine, queries[0])
        # single-query requests from 8 concurrent clients, with the kernels'
        # launches and the batches they rode in counted around them
        pool0, resc0 = fused_splade_pool.launches, rescore_match.launches
        batches0 = service.batcher.stats()["batches"]

        def client(i):
            for q in queries[i::8]:
                for k in (10, 100):
                    _, dt = _http(addr, "POST", "/search", {"query": q, "k": k})
                    lat.append(dt)

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        assert not any(c.is_alive() for c in clients)
        assert len(lat) == 2 * len(queries), len(lat)
        batches = service.batcher.stats()["batches"] - batches0
        per = {kname: dict(launches=n, per_request=n / len(lat),
                           per_batch=n / batches)
               for kname, n in (
                   ("fused_splade_pool", fused_splade_pool.launches - pool0),
                   ("rescore_match", rescore_match.launches - resc0))}
        enc, _ = _http(addr, "POST", "/encode",
                       {"texts": queries[:2], "queries": True})
        assert all(len(v) > 0 for v in enc["vectors"]), name
        added, _ = _http(addr, "POST", "/index",
                         {"docs": [{"id": "fresh-doc", "text": doc_text}]})
        assert added["added"] == 1, added
        after, _ = _http(addr, "POST", "/search",
                         {"query": doc_text, "k": 10})
        ids = [r["doc_id"] for r in after["results"][0]]
        assert "fresh-doc" in ids, (name, ids)
        stats, _ = _http(addr, "GET", "/stats")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    summary = dict(
        p50_ms=float(np.percentile(lat_ms, 50)),
        p99_ms=float(np.percentile(lat_ms, 99)),
        requests=len(lat), batches=batches,
        fresh_doc_rank=ids.index("fresh-doc"),
        mean_batch=stats["mean_batch_size"], kernel_launches=per)
    log(f"  {name}: {engine.num_docs} docs, single-query /search latency "
        f"p50 {summary['p50_ms']:.2f} ms p99 {summary['p99_ms']:.2f} ms over "
        f"{len(lat)} requests in {batches} batches; kernel launches "
        + ", ".join(f"{k} {v['launches']} ({v['per_request']:.3f}/request, "
                    f"{v['per_batch']:.2f}/batch)" for k, v in per.items())
        + f"; /index doc found at rank {summary['fresh_doc_rank']}")
    return summary


def summarize_spans(spans, n_top: int = 8):
    """(busy microseconds, {name: ms} of the n_top largest) from device
    spans (start_us, end_us, name) sorted by start: busy is the union of
    the intervals; names are cut to 60 characters and kernels that then
    share a name (template instances of one kind) are added together."""
    busy_us, end_us, by_name = 0.0, float("-inf"), {}
    for start, end, kname in spans:
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
        by_name[kname[:60]] = by_name.get(kname[:60], 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return busy_us, {k: v / 1e3 for k, v in top}


#: the port's own kernels among a trace's device spans, by function name
PORT_KERNEL = re.compile(r"((?:fused_splade|splash|rescore)\w*_kernel)")
#: the per-row pool backward's kernels (the match pass and the gathers)
POOL_BACKWARD = ("fused_splade_bwd_match_kernel", "fused_splade_bwd_dh_kernel",
                 "fused_splade_bwd_dw_kernel")


def port_kernels_ms(spans) -> dict:
    """{kernel function: ms} of the port's own kernels among device spans
    (start_us, end_us, name), whatever their rank."""
    out = {}
    for start, end, kname in spans:
        hit = PORT_KERNEL.search(kname)
        if hit:
            out[hit.group(1)] = out.get(hit.group(1), 0.0) + (end - start) / 1e3
    return out


def device_profile(torch, fn) -> dict:
    """Host wall clock of ``fn()`` ended by a synchronize, against the union
    of the device's kernel and copy intervals in a torch.profiler trace,
    and the device items that take most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return dict(wall_ms=wall_ms, device_busy_ms=None)
    busy_us, top = summarize_spans(spans)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                device_idle_share=1.0 - busy_us / 1e3 / wall_ms,
                device_ops=len(spans), top_kernels_ms=top,
                port_kernels_ms=port_kernels_ms(spans))


def profile_batch(torch, name: str, engine, queries) -> dict:
    """Where one warmed search batch of len(queries) at k=100 spends its
    time (device_profile)."""
    engine.search_batch(queries, k=100)
    out = dict(batch=len(queries), **device_profile(
        torch, lambda: engine.search_batch(queries, k=100)))
    if out["device_busy_ms"] is None:
        log(f"  {name} B={len(queries)}: wall {out['wall_ms']:.2f} ms; the "
            "profiler saw no device activity, device time not measured")
        return out
    top = list(out["top_kernels_ms"].items())
    log(f"  {name} B={len(queries)} k=100 batch: wall {out['wall_ms']:.2f} ms, "
        f"device busy {out['device_busy_ms']:.2f} ms (idle "
        f"{out['device_idle_share']:.0%}) over {out['device_ops']} device ops; "
        "top: " + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top[:5]))
    return out


def compare_with_plain_path(name, engine, model, queries, served) -> None:
    """Run the same queries through the port's plain path (pool_impl
    'streamed', rescore 'gather' = exact_rescore) and hold the served
    results against them. No kernel launches here."""
    os.environ["SPLADE_RESCORE"] = "gather"
    model.pool_impl = "streamed"
    try:
        for k, got in served.items():
            compare_served(f"{name} k={k}", got,
                           engine.search_batch(queries, k=k))
    finally:
        model.pool_impl = "kernel"
        del os.environ["SPLADE_RESCORE"]


def compare_search_vector(name, engine, query: str, k: int = 10) -> None:
    """The served index's own single-query search, ``search_vector``, on the
    vector the engine's encoder gives one query, held against the engine's
    search of the same text (compare_served). The query is encoded in the
    padded batch the engine encodes it in, so both see the same vector."""
    idx, val = engine.encoder.encode_queries(
        [query] + [""] * (engine.batch_pad - 1))[0]
    compare_served(f"{name} search_vector k={k}",
                   [engine.index.search_vector(idx, val, k=k)],
                   [engine.search(query, k=k)])


def compare_doc_encode(torch, enc, model, texts) -> float:
    """The document vectors the postings engine indexed (pool_impl
    'kernel', S = doc_max_length) against the plain path's on the same
    texts, as dense [B, V] rows: within SERVE_RTOL of each row's largest
    weight. Returns the largest relative difference."""
    worst = 0.0
    for i in range(0, len(texts), enc.batch_size):
        batch = enc.tokenize(texts[i:i + enc.batch_size], enc.doc_max_length)
        got = enc.encode_tensor(*batch)
        model.pool_impl = "streamed"
        try:
            want = enc.encode_tensor(*batch)
        finally:
            model.pool_impl = "kernel"
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-6)
        worst = max(worst, float(((got - want).abs() / scale).max()))
    log(f"  document encode S={enc.doc_max_length}, {len(texts)} docs: "
        f"kernel == plain path (max relative diff {worst:.2e}, "
        f"tol {SERVE_RTOL})")
    if not worst <= SERVE_RTOL:
        raise SystemExit("document vectors differ from the plain path")
    return worst


def compare_served(name, served, plain) -> None:
    """Same ids where scores are separated by more than SERVE_RTOL; tied
    groups as sets; scores within SERVE_RTOL."""
    worst = 0.0
    for sr, pr in zip(served, plain):
        assert len(sr) == len(pr), name
        s = np.array([x for _, x in sr])
        p = np.array([x for _, x in pr])
        tol = SERVE_RTOL * max(float(np.abs(p).max(initial=0)), 1e-6)
        worst = max(worst, float(np.abs(s - p).max(initial=0)) / max(
            float(np.abs(p).max(initial=0)), 1e-6))
        if not np.allclose(s, p, rtol=0, atol=tol):
            raise SystemExit(f"{name}: served scores differ from the plain "
                             f"path: {s[:5]} vs {p[:5]}")
        start = 0
        while start < len(p):
            end = start + 1
            while end < len(p) and abs(p[end] - p[end - 1]) <= tol:
                end += 1
            if end < len(p) and ({d for d, _ in sr[start:end]}
                                 != {d for d, _ in pr[start:end]}):
                raise SystemExit(f"{name}: served ids differ from the plain "
                                 f"path at ranks {start}-{end}")
            start = end
    log(f"  {name}: served == plain path (max relative score diff "
        f"{worst:.2e}, tol {SERVE_RTOL})")


# ------------------------------------------------------------ phase 4
def v33_recipe() -> dict:
    """The canonical V33 recipe of configs/train_v33.yaml, built in code
    (the card machine may lack PyYAML); tests/test_torch_chip_smoke.py holds
    it equal to the file."""
    return {
        "model": {"name": "skt/A.X-Encoder-base", "dtype": "bfloat16",
                  "remat": True},
        "loss": {"lambda_q": 0.01, "lambda_d": 0.003, "temperature": 1.0,
                 "flops_warmup_steps": 20000, "lambda_initial_ratio": 0.1},
        "data": {"train_files": ["data/v29.0/train_*.jsonl"],
                 "val_files": ["data/v29.0/val.jsonl"], "batch_size": 64,
                 "query_max_length": 64, "doc_max_length": 256},
        "training": {"num_epochs": 25, "learning_rate": 5.0e-5,
                     "weight_decay": 0.01, "warmup_ratio": 0.06,
                     "gradient_clip": 1.0, "gradient_accumulation_steps": 4,
                     "output_dir": "outputs/train_v33", "seed": 42},
    }


def synth_triplets(rng, n: int, doc_words=(100, 129)) -> list:
    """Hangul (query, positive, negative) triplets: queries of 4-16 words
    (8-32 tokens of the character stand-in tokenizer), documents of
    doc_words words (two syllables each: most of 256 positions filled)."""
    def words(lo, hi):
        return hangul_texts(rng, 1, int(rng.integers(lo, hi)))[0]

    return [{"query": words(4, 17), "positive": words(*doc_words),
             "negative": words(*doc_words)} for _ in range(n)]


def compare_routes(torch, model, routes, set_route, run_loss, what: str,
                   loss_rtol: float, grad_rtol: float) -> dict:
    """One micro-batch through two routes of ``model`` from the same
    parameters: ``routes`` = (the route under test, the route it is held
    against), ``set_route(name)`` switches the model, ``run_loss()`` returns
    the loss with the graph. Loss and the gradients' global norm must agree
    within ``loss_rtol`` and every parameter's gradient (norm-relative)
    within ``grad_rtol``. The model is left on the first route with no
    gradients."""
    found = {}
    try:
        for name in routes:
            set_route(name)
            model.zero_grad(set_to_none=True)
            loss = run_loss()
            loss.backward()
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters() if p.grad is not None}
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
            found[name] = (float(loss.detach()), float(norm), grads)
    finally:
        set_route(routes[0])
        model.zero_grad(set_to_none=True)
    (k_loss, k_norm, k_grads), (p_loss, p_norm, p_grads) = (
        found[routes[0]], found[routes[1]])
    loss_err = abs(k_loss - p_loss) / max(abs(p_loss), 1e-12)
    norm_err = abs(k_norm - p_norm) / max(p_norm, 1e-12)
    tensor_err = {}
    for name in sorted(set(k_grads) | set(p_grads)):
        if name not in k_grads or name not in p_grads:
            tensor_err[name] = 1.0  # a gradient one route never produced
            continue
        ref = p_grads[name].float()
        tensor_err[name] = float((k_grads[name].float() - ref).norm()
                                 / ref.norm().clamp_min(1e-30))
    worst = max(tensor_err, key=tensor_err.get)
    finite = all(bool(torch.isfinite(g).all()) for g in k_grads.values())
    shared = set(k_grads) & set(p_grads)
    all_err = float(torch.sqrt(sum(
        ((k_grads[n].float() - p_grads[n].float()) ** 2).sum()
        for n in shared))) / max(p_norm, 1e-30)
    out = {f"loss_{routes[0]}": k_loss, f"loss_{routes[1]}": p_loss,
           "loss_rel_err": loss_err, f"grad_norm_{routes[0]}": k_norm,
           f"grad_norm_{routes[1]}": p_norm, "grad_norm_rel_err": norm_err,
           "worst_tensor": worst, "worst_tensor_rel_err": tensor_err[worst],
           "all_gradients_rel_err": all_err,
           "tensors": len(tensor_err), "finite": finite,
           "loss_rtol": loss_rtol, "grad_rtol": grad_rtol}
    log(f"  {routes[0]} vs {routes[1]} route, one micro-batch: loss "
        f"{k_loss:.6f} vs {p_loss:.6f} (rel {loss_err:.2e}), grad_norm "
        f"{k_norm:.6f} vs {p_norm:.6f} (rel {norm_err:.2e}), worst of "
        f"{len(tensor_err)} gradients {worst} {tensor_err[worst]:.2e}, all "
        f"gradients together {all_err:.2e} (tol {loss_rtol:.3g} / "
        f"{grad_rtol:.3g})")
    if not (finite and loss_err <= loss_rtol and norm_err <= loss_rtol
            and tensor_err[worst] <= grad_rtol):
        raise SystemExit(f"{what}: the {routes[0]} route's loss or gradients "
                         f"differ from the {routes[1]} route's")
    return out


def compare_train_routes(torch, model, cfg, micro, step: int) -> dict:
    """One micro-batch through the kernel route and through the plain route
    (pool_impl 'streamed', autograd through the streamed maxima) from the
    same parameters (``compare_routes``). The tied embedding is first rounded
    to bf16 values in place, so that the kernels' bf16 operands and the
    streamed path's f32 ones hold the same numbers; the two routes then
    differ by the order of f32 sums (and the rare argmax a near-tie flips),
    where a dropped dbias or a backward that finds no argmax moves a
    gradient by its whole size."""
    from splade_tpu_torch.train.trainer import compute_autocast, make_loss_fn

    with torch.no_grad():
        emb = model.mlm.decoder.weight
        emb.copy_(emb.to(torch.bfloat16).to(emb.dtype))
    dev = next(model.parameters()).device
    loss_fn = make_loss_fn(
        model, cfg.loss, 1, packed_query=cfg.model.packed_query_tower,
        autocast=lambda: compute_autocast(cfg.model, dev))
    return compare_routes(
        torch, model, ("kernel", "plain"),
        lambda name: setattr(model, "pool_impl",
                             "kernel" if name == "kernel" else "streamed"),
        lambda: loss_fn(micro, step)[0], "training", TRAIN_RTOL,
        TRAIN_GRAD_RTOL)


def sdpa_forward_with_f32_scores(self, x, attn_bias, cos, sin, seg=None):
    """``ModernBertAttention.forward``'s sdpa route with one change: under
    autocast the q . k product is taken in f32 on the bf16 operands, where
    the model's own rounds the scores to bf16. A measuring instrument: the
    gradients it gives differ from the sdpa route's by rounding noise alone,
    which is the floor under any comparison of two attention routes."""
    import math

    import torch

    from splade_tpu_torch.models.modernbert import apply_rope

    B, S, H = x.shape
    qkv = self.Wqkv(x).view(B, S, 3, self.n_heads, self.head_dim)
    q, k, v = qkv.unbind(2)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    operand = (torch.get_autocast_dtype(x.device.type)
               if torch.is_autocast_enabled(x.device.type) else q.dtype)
    with torch.autocast(x.device.type, enabled=False):
        scores = torch.einsum("bqnd,bknd->bnqk", q.to(operand).float(),
                              k.to(operand).float())
    scores = scores / math.sqrt(self.head_dim) + attn_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(B, S, H)
    return self.Wo(out)


def compare_attention_routes(torch, mlm_model, run_loss, what: str) -> dict:
    """One micro-batch through ``attention_impl`` "splash" (the hand-written
    attention kernels on the card) and "sdpa" (the plain attention) from the
    same parameters and batch (``compare_routes``): valid positions compute
    the same function in both, padded ones feed nothing that is read. First
    the noise floor: the sdpa route with its scores kept in f32
    (``sdpa_forward_with_f32_scores``) against the sdpa route; each gradient
    tensor of the splash route is then held to twice the floor's worst
    tensor, within the bounds of SPLASH_TRAIN_GRAD_RTOL."""
    import dataclasses

    from splade_tpu_torch.models.modernbert import ModernBertAttention

    own_forward = ModernBertAttention.forward

    def set_route(name):
        mlm_model.config = dataclasses.replace(
            mlm_model.config,
            attention_impl="splash" if name == "splash" else "sdpa")
        ModernBertAttention.forward = (
            sdpa_forward_with_f32_scores if name == "sdpa_f32_scores"
            else own_forward)

    least, most = SPLASH_TRAIN_GRAD_RTOL
    try:
        floor = compare_routes(torch, mlm_model, ("sdpa_f32_scores", "sdpa"),
                               set_route, run_loss, what, float("inf"),
                               float("inf"))
        out = compare_routes(
            torch, mlm_model, ("splash", "sdpa"), set_route, run_loss, what,
            SPLASH_TRAIN_RTOL,
            min(max(2 * floor["worst_tensor_rel_err"], least), most))
    finally:
        set_route("splash")
    out["noise_floor"] = {k: floor[k] for k in (
        "loss_rel_err", "grad_norm_rel_err", "worst_tensor",
        "worst_tensor_rel_err", "all_gradients_rel_err")}
    return out


def device_gb_in_use(torch, device: str):
    """Device memory still allocated once unreachable objects of earlier
    phases are collected: what a phase's peak stands on (None on the CPU)."""
    import gc

    if device != "cuda":
        return None
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def _counted_kernels() -> dict:
    """name -> the wrapper whose ``launches`` counts that kernel, for the
    kernels a training path can launch: the per-row pool family and the
    splash attention."""
    from splade_tpu_torch.ops import fused_splade, splash_attention

    return {"fused_splade_pool": fused_splade.fused_splade_pool,
            "fused_splade_bwd_match": fused_splade.fused_splade_bwd_match,
            "fused_splade_bwd_dh": fused_splade.fused_splade_bwd_dh,
            "fused_splade_bwd_dw": fused_splade.fused_splade_bwd_dw,
            "splash_attention": splash_attention.splash_attention,
            "splash_attention_bwd_dq":
                splash_attention.splash_attention_bwd_dq,
            "splash_attention_bwd_dkv":
                splash_attention.splash_attention_bwd_dkv}


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in _counted_kernels().items()}


def _reset_launch_counts() -> None:
    for fn in _counted_kernels().values():
        fn.launches = 0


def expected_launches(model_config, accum: int, steps: int,
                      pool_per_micro: int) -> dict:
    """Launches ``steps`` optimizer steps of ``accum`` micro-batches must
    count, from the code: the pool kernels ``pool_per_micro`` times a
    micro-batch each (2 in the V33 step: documents and queries; 0 in MLM),
    the backward's match pass once with its two gathers;
    with attention_impl "splash" every layer launches the attention forward
    once (twice under layer recompute, whose backward re-runs it) and each
    backward kernel once; with "sdpa" none."""
    layers = (model_config.num_hidden_layers
              if model_config.attention_impl == "splash" else 0)
    micro = accum * steps
    return {"fused_splade_pool": pool_per_micro * micro,
            "fused_splade_bwd_match": pool_per_micro * micro,
            "fused_splade_bwd_dh": pool_per_micro * micro,
            "fused_splade_bwd_dw": pool_per_micro * micro,
            "splash_attention": layers * (2 if model_config.remat else 1)
            * micro,
            "splash_attention_bwd_dq": layers * micro,
            "splash_attention_bwd_dkv": layers * micro}


def hold_launches(what: str, got: dict, want: dict) -> None:
    """Fail on any launch count that is not the one the code implies."""
    log(f"  {what}: kernel launches {got}, expected {want}")
    if got != want:
        raise SystemExit(f"{what}: kernel launches {got}, expected {want}")


def train_phase(torch, tok, rng, workdir, seed: int, recipe: dict,
                model_config, steps: int = 3, device: str = "cuda",
                doc_words=(100, 129)) -> dict:
    """The V33 training path through the port's entry points: synthetic
    triplets written as JSONL, load_training_data -> TripletCollator ->
    Trainer (its dataloader, prefetcher, train step and AdamW). One warm-up
    step, then ``steps`` optimizer steps (counted and timed), one more under
    torch.profiler, a checkpoint resumed by a fresh Trainer that must take
    the same step, and one micro-batch held against the plain route."""
    import shutil
    from pathlib import Path

    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from splade_tpu_torch.train.trainer import Trainer, pin_batch, to_device

    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    gb_at_start = device_gb_in_use(torch, device)
    cfg_dict = json.loads(json.dumps(recipe))
    cfg_dict["data"]["train_files"] = [str(workdir / "train_*.jsonl")]
    cfg_dict["data"]["val_files"] = []
    # max_steps stays 0 here: the Trainers' schedules span the recipe's
    # whole run over these triplets (its 25 epochs, warm-up 6% of them), so
    # every step after the first has a learning rate above 0; the run is
    # cut by raising max_steps after construction
    cfg_dict["training"].update(output_dir=str(workdir / "run"),
                                log_every_n_steps=1,
                                watchdog_timeout_s=WATCHDOG_S)
    cfg_dict["mesh"] = {"num_data": 1}
    batch = cfg_dict["data"]["batch_size"]
    accum = cfg_dict["training"]["gradient_accumulation_steps"]
    n = batch * accum * (steps + 3)  # warm-up, measured, profiled, resumed
    t0 = time.perf_counter()
    with open(workdir / "train_000.jsonl", "w", encoding="utf-8") as f:
        for row in synth_triplets(rng, n, doc_words):
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    data = load_training_data(cfg_dict["data"]["train_files"])

    def new_trainer(model_seed):
        cfg = V33Config.from_dict(json.loads(json.dumps(cfg_dict)))
        collator = TripletCollator(
            tok, query_max_length=cfg.data.query_max_length,
            doc_max_length=cfg.data.doc_max_length,
            num_hard_negatives=cfg.data.num_hard_negatives)
        model = SpladeEncoder(model_config, pool_impl="kernel",
                              with_token_weights=False,
                              device=device).init_weights(model_seed)
        return Trainer(cfg, model, data, collator, device=device)

    trainer = new_trainer(seed)
    cfg = trainer.cfg
    enc = trainer.loader.collate_fn([data[i] for i in range(batch)])
    fill = dict(query_tokens=float(enc["query_attention_mask"].sum(1).mean()),
                doc_tokens=float(enc["positive_attention_mask"].sum(1).mean()))
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"  {len(data)} triplets written and loaded, mean tokens query "
        f"{fill['query_tokens']:.1f} / doc {fill['doc_tokens']:.1f} of "
        f"{cfg.data.query_max_length} / {cfg.data.doc_max_length}; model "
        f"{n_params / 1e6:.1f}M params (f32 master, {cfg.model.dtype} "
        f"compute, remat {cfg.model.remat}); set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # warm-up step (first launches, allocator growth)
    cfg.training.max_steps = 1
    t0 = time.perf_counter()
    trainer.train_epoch(1)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    warmup_s = time.perf_counter() - t0
    # the measured steps, through Trainer.train
    cfg.training.max_steps = 1 + steps
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.train()
    sync()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else None)
    if state.step != 1 + steps:
        raise SystemExit(f"training stopped at step {state.step}")
    wd = trainer._watchdog
    wd._thread.join(timeout=5.0)
    watchdog = dict(timeout_s=wd.timeout_s, beats=wd.beats,
                    tripped=wd.tripped, stopped=not wd._thread.is_alive())
    log(f"  hang watchdog armed at {wd.timeout_s:.0f} s over the measured "
        f"steps: {wd.beats} beats (a resolved loss each logged step, the "
        f"checkpoint write), tripped: {wd.tripped}, thread stopped after "
        f"train(): {watchdog['stopped']}")
    if not (wd.beats >= steps and not wd.tripped and watchdog["stopped"]):
        raise SystemExit("training: the hang watchdog did not beat, or "
                         "tripped, or outlived train()")
    records = [json.loads(line) for line in
               (workdir / "run" / "metrics.jsonl").read_text().splitlines()]
    per_step = [{k: r[k] for k in ("step", "loss", "infonce", "nonzero_q",
                                   "nonzero_d", "grad_norm", "lambda_q")}
                for r in records]  # step 1 is the warm-up step
    for r in per_step:
        log(f"  step {r['step']}{' (warm-up)' if r['step'] == 1 else ''}: "
            f"loss {r['loss']:.5f} infonce "
            f"{r['infonce']:.5f} nnz(q/d) {r['nonzero_q']:.0f}/"
            f"{r['nonzero_d']:.0f} grad_norm {r['grad_norm']:.5f}")
    if not all(np.isfinite(r["loss"]) for r in per_step):
        raise SystemExit("training: non-finite loss")
    triplets = steps * batch * accum
    per_opt_step = {k: v / steps for k, v in launches.items()}
    log(f"  {steps} steps in {wall:.2f} s: {triplets / wall:.1f} triplets/s, "
        f"{wall / steps * 1e3:.0f} ms a step (warm-up step {warmup_s:.1f} s); "
        f"kernel launches a step {per_opt_step}; "
        f"peak device memory "
        + (f"{peak_gb:.2f} GB ({gb_at_start:.2f} GB in use before the phase)"
           if peak_gb is not None else "not measured"))

    # one more step: the checkpoint first, then the step under the profiler
    ckpt = save_checkpoint(str(workdir), state, cfg, epoch=1)
    macros = trainer._macro_batches(1, skip_macros=state.step)
    host = next(macros)
    macros.close()  # stops the loader's collation thread
    dev_batch = to_device(pin_batch(host, device == "cuda"), trainer.device)
    lr_live = state.optimizer.param_groups[0]["lr"]
    box = {}
    if device == "cuda":
        prof = device_profile(torch, lambda: box.setdefault(
            "m", trainer.step_fn(state, dev_batch)))
        top = list(prof.get("top_kernels_ms", {}).items())
        log(f"  one step under torch.profiler: wall {prof['wall_ms']:.1f} ms"
            + (f", device busy {prof['device_busy_ms']:.1f} ms (idle "
               f"{prof['device_idle_share']:.1%}) over {prof['device_ops']} "
               "device ops; top: " + ", ".join(f"{k[:48]} {v:.2f}"
                                              for k, v in top[:6])
               if prof["device_busy_ms"] is not None
               else "; the profiler saw no device activity, not measured"))
    else:
        box["m"] = trainer.step_fn(state, dev_batch)
        prof = None
    live = {k: float(v) for k, v in box["m"].items()}

    # resume: a fresh Trainer from the checkpoint takes the same step. The
    # step's learning rate is above 0 and it moves the parameters, so a
    # fault in the restored AdamW moments or schedule would show
    trainer.model.zero_grad(set_to_none=True)
    fresh = new_trainer(seed + 1)
    fresh.state, meta = load_checkpoint(ckpt, fresh.state)
    pairs = list(zip(state.model.parameters(), fresh.state.model.parameters()))
    with torch.no_grad():
        moved = max(float((a - b).abs().max()) for a, b in pairs)
    lr_resumed = fresh.state.optimizer.param_groups[0]["lr"]
    resumed = {k: float(v) for k, v in
               fresh.step_fn(fresh.state, dev_batch).items()}
    bitwise = (all(torch.equal(a, b) for a, b in pairs)
               and resumed["loss"] == live["loss"])
    param_diff = max(float((a - b).detach().abs().max()) for a, b in pairs)
    resume = dict(full_resume=meta["full_resume"], step=fresh.state.step,
                  lr=lr_resumed, lr_live=lr_live,
                  total_steps=trainer.total_steps, step_moved_params=moved,
                  bitwise=bitwise, max_param_diff=param_diff,
                  loss_live=live["loss"], loss_resumed=resumed["loss"])
    log(f"  resumed from {Path(ckpt).name}: step {fresh.state.step} at lr "
        f"{lr_resumed:.3e} (uninterrupted {lr_live:.3e}; schedule of "
        f"{trainer.total_steps} steps), which moved the parameters by up to "
        f"{moved:.2e}; loss {resumed['loss']:.6f} vs uninterrupted "
        f"{live['loss']:.6f}, parameters "
        f"{'bitwise equal' if bitwise else f'max diff {param_diff:.2e}'}"
        f" (tol {RESUME_ATOL})")
    if not (meta["full_resume"] and fresh.state.step == state.step
            and lr_resumed > 0 and lr_resumed == lr_live and moved > 0
            and param_diff <= RESUME_ATOL
            and abs(resumed["loss"] - live["loss"])
            <= RESUME_ATOL * max(1.0, abs(live["loss"]))):
        raise SystemExit("training: the resumed step differs")
    del trainer, state

    # the plain route on the first micro-batch of that step
    micro = {k: v[0] for k, v in dev_batch.items()}
    plain = compare_train_routes(torch, fresh.model, cfg, micro,
                                 fresh.state.step)
    attention = None
    if model_config.attention_impl == "splash":
        from splade_tpu_torch.train.trainer import (compute_autocast,
                                                    make_loss_fn)
        loss_fn = make_loss_fn(
            fresh.model, cfg.loss, 1,
            packed_query=cfg.model.packed_query_tower,
            autocast=lambda: compute_autocast(cfg.model, fresh.device))
        attention = compare_attention_routes(
            torch, fresh.model.mlm,
            lambda: loss_fn(micro, fresh.state.step)[0], "training")
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(recipe=recipe, model_params=n_params, triplets=len(data),
                mean_tokens=fill, steps=per_step,
                measured_steps=steps, wall_s=wall,
                triplets_per_s=triplets / wall, step_ms=wall / steps * 1e3,
                warmup_step_s=warmup_s, launches=launches,
                launches_per_step=per_opt_step, peak_device_gb=peak_gb,
                device_gb_at_start=gb_at_start,
                profile=prof, profiled_step=live, resume=resume,
                plain_route=plain, attention_route=attention,
                watchdog=watchdog)


# ------------------------------------------------------------ phase 5
def mlm_recipe() -> dict:
    """The MLM recipe of configs/pretrain_mlm.yaml, built in code (the card
    machine may lack PyYAML); tests/test_torch_chip_smoke.py holds it equal
    to the file."""
    return {
        "model_name": "skt/A.X-Encoder-base", "data_dir": "data/mlm_korean",
        "max_length": 512, "output_dir": "outputs/pretrain_mlm", "epochs": 3,
        "batch_size": 32, "grad_accum": 4, "lr": 5.0e-5,
        "weight_decay": 0.01, "warmup_ratio": 0.05, "mlm_probability": 0.15,
        "save_steps": 2000, "eval_steps": 1000, "logging_steps": 100,
        "dataloader_workers": 4, "seed": 42, "val_fraction": 0.01,
        "dtype": "bfloat16",
    }


def _sigterm_after(trainer, records: int) -> threading.Thread:
    """A thread that sends SIGTERM to this process once the trainer has
    logged ``records`` steps: the signal lands while a later step runs."""
    def watch():
        while trainer.tracker.num_records < records:
            time.sleep(0.002)
        os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=watch, daemon=True, name="sigterm")
    thread.start()
    return thread


def v2_path(torch, mlm_model, tok, rng, autocast, shapes) -> dict:
    """The row-blocked pool family's path: its public function under
    autograd, on the pre-trained model, at the (B, S) phase 2 held the
    family's wrappers at. For each (B, S) a batch of texts
    is encoded, head-transformed, pooled by ``fused_splade_pool_v2``
    (row_block 0: the automatic choice) and a FLOPS-style sparsity loss
    (the squared mean activation of each vocabulary entry) is sent backward
    into the model. The family's launch counts are set to 0 before and read
    after. The same batches then go through the per-row family
    (``fused_splade_pool``): the loss must agree within TRAIN_RTOL, the
    gradients' global norm within TRAIN_RTOL and each tensor within
    TRAIN_GRAD_RTOL. On the card, the family's whole backward (its match
    pass, then both gathers) is also timed on each batch's own states, mask
    and cotangent, with the batch's valid share: the traffic this path
    sends (short texts, mostly padding)."""
    from splade_tpu_torch.ops import fused_splade_v2 as v2
    from splade_tpu_torch.ops.fused_splade import fused_splade_pool

    dev = next(mlm_model.parameters()).device
    batches = []
    for B, S in shapes:
        enc = tok(hangul_texts(rng, B, max(S // 3, 2)), max_length=S)
        batches.append((torch.from_numpy(enc["input_ids"]).to(dev),
                        torch.from_numpy(enc["attention_mask"]).to(dev)))

    def route(pool):
        mlm_model.zero_grad(set_to_none=True)
        total = 0.0
        for ids, mask in batches:
            with autocast():
                h = mlm_model.head_transform(mlm_model.encode(ids, mask))
                h = h.to(torch.bfloat16) if dev.type == "cuda" else h
                w, bias = mlm_model.decoder_weights()
                pooled, tw = pool(h, w.to(h.dtype), bias, mask)
            loss = (pooled.mean(0) ** 2).sum()
            loss.backward()
            total += float(loss.detach())
        grads = {n: p.grad.detach().clone()
                 for n, p in mlm_model.named_parameters()
                 if p.grad is not None}
        norm = float(torch.sqrt(sum((g.float() ** 2).sum()
                                    for g in grads.values())))
        mlm_model.zero_grad(set_to_none=True)
        return total, norm, grads, tuple(pooled.shape), tuple(tw.shape)

    names = ("fused_splade_pool_v2", "fused_splade_bwd_match_v2",
             "fused_splade_bwd_dh_v2", "fused_splade_bwd_dw_v2")
    counters = [getattr(v2, name) for name in names]
    was_training = mlm_model.training
    mlm_model.train()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    loss2, norm2, grads2, p_shape, tw_shape = route(v2.fused_splade_pool_v2)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if dev.type == "cuda" else None)
    launches = {name: fn.launches for name, fn in zip(names, counters)}
    loss1, norm1, grads1, _, _ = route(fused_splade_pool)
    backward = [batch_backward_times(torch, mlm_model, ids, mask)
                for ids, mask in batches] if dev.type == "cuda" else []
    mlm_model.train(was_training)
    loss_err = abs(loss2 - loss1) / max(abs(loss1), 1e-12)
    norm_err = abs(norm2 - norm1) / max(norm1, 1e-12)
    tensor_err = {n: float((grads2[n].float() - g.float()).norm()
                           / g.float().norm().clamp_min(1e-30))
                  if n in grads2 else 1.0 for n, g in grads1.items()}
    worst = max(tensor_err, key=tensor_err.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads2.values())
    last_B, last_S = shapes[-1]
    log(f"  row-blocked pool under autograd over {len(shapes)} batches "
        f"{list(shapes)} in {seconds:.2f} s (peak device memory {peak_gb} "
        f"GB): launches {launches}; sparsity "
        f"loss {loss2:.6f} vs per-row family {loss1:.6f} (rel "
        f"{loss_err:.2e}), grad_norm {norm2:.6f} vs {norm1:.6f} (rel "
        f"{norm_err:.2e}), worst of {len(tensor_err)} gradients {worst} "
        f"{tensor_err[worst]:.2e} (tol {TRAIN_RTOL} / {TRAIN_GRAD_RTOL}); "
        f"finite: {finite}" + "".join(
            f"; B={x['B']} S={x['S']} ({x['valid_share']:.1%} of positions "
            f"valid, {x['live_group_share']:.1%} of 16-row groups live, "
            f"row_block {x['row_block']}): the whole backward "
            f"{x['backward_ms']:.3f} ms (match pass {x['match_ms']:.3f})"
            for x in backward))
    if not (p_shape == (last_B, V) and tw_shape == (last_B, last_S)
            and finite and len(grads2) == len(grads1)
            and loss_err <= TRAIN_RTOL and norm_err <= TRAIN_RTOL
            and tensor_err[worst] <= TRAIN_GRAD_RTOL):
        raise SystemExit("the row-blocked pool's route differs from the "
                         "per-row family's")
    return dict(shapes=[list(x) for x in shapes], launches=launches,
                seconds=seconds, peak_device_gb=peak_gb, loss=loss2,
                loss_v1=loss1,
                loss_rel_err=loss_err, grad_norm=norm2, grad_norm_v1=norm1,
                grad_norm_rel_err=norm_err, worst_tensor=worst,
                worst_tensor_rel_err=tensor_err[worst],
                tensors=len(tensor_err), backward_on_its_batches=backward)


def batch_backward_times(torch, mlm_model, ids, mask) -> dict:
    """The row-blocked family's backward kernels (its match pass, then the
    dh and dW gathers) timed on one of v2_path's batches: the batch's own
    states, mask and the sparsity loss's cotangent, at row_block 0, as the
    path runs them. Launches here are not the path's: they come after its
    counts were read."""
    from splade_tpu_torch.ops import fused_splade_v2 as v2
    from splade_tpu_torch.ops.fused_splade import (_bwd_operands,
                                                   fold_cotangent,
                                                   launch_match,
                                                   launch_match_gather)

    B, S = mask.shape
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        h = mlm_model.head_transform(mlm_model.encode(ids, mask))
    h = h.to(torch.bfloat16).contiguous()
    w, bias = mlm_model.decoder_weights()
    w, bias = w.detach().to(torch.bfloat16), bias.detach()
    with torch.no_grad():
        m, _ = v2.fused_splade_maxima_v2(h, w, bias, mask)
        pooled = torch.log1p(torch.relu(m))
        # d/dpooled of (pooled.mean(0) ** 2).sum()
        g_pre = fold_cotangent(2.0 * pooled.mean(0, keepdim=True)
                               .expand(B, -1) / B, m)
        ops = _bwd_operands(h, w, bias, mask, m, g_pre)
        ext = v2.ROW_BLOCKED.block_args(ops.hb, 0, True)
        return dict(
            B=B, S=S, row_block=ext[0],
            valid_share=float(mask.float().mean()),
            live_group_share=live_group_share(torch, mask.float()),
            match_ms=cuda_ms(torch, lambda: launch_match(
                v2.ROW_BLOCKED, ops, ext), iters=5, warmup=1),
            backward_ms=cuda_ms(torch, lambda: launch_match_gather(
                v2.ROW_BLOCKED, ops, ext, ("dh", "dw")), iters=5, warmup=1))


def mlm_phase(torch, tok, rng, workdir, seed: int, recipe: dict,
              model_config, steps: int = 3, device: str = "cuda",
              n_sentences: int = 20_000, sentence_words=(12, 28),
              v2_shapes=TRAIN_POOL_SHAPES, checkpoint_config=None
              ) -> dict:
    """MLM pre-training through the port's entry points: a synthetic Hangul
    corpus written as a text shard, read_corpus -> pack_corpus ->
    MLMTrainer. One run of train(): a warm-up step, ``steps`` measured
    steps (timed from the trainer's own step records, each written after
    the loss resolved on the host), then SIGTERM, which must end the run at
    a step boundary with a checkpoint. Then the next step under the
    profiler, the same step by a trainer resumed from the checkpoint
    (bitwise), held-out evaluation, the final model through
    SparseEncoderV33.from_checkpoint into a served engine, and the
    row-blocked pool's path (``v2_path``). ``checkpoint_config`` is handed
    to from_checkpoint (None: the architecture's widths with the
    tokenizer's vocabulary, as a user loads a full-size model)."""
    import shutil

    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.serving.engine import build_engine_from_docs
    from splade_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                   load_checkpoint,
                                                   save_final_model)
    from splade_tpu_torch.train.mlm import (MLMConfig, MLMTrainer,
                                            pack_corpus, read_corpus)

    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    (workdir / "corpus").mkdir(parents=True)
    gb_at_start = device_gb_in_use(torch, device)
    t0 = time.perf_counter()
    lo, hi = sentence_words
    cuts = rng.integers(lo, hi, n_sentences)
    with open(workdir / "corpus" / "mlm_000.txt", "w", encoding="utf-8") as f:
        for text, n_words in zip(hangul_texts(rng, n_sentences, hi - 1), cuts):
            f.write(" ".join(text.split(" ")[:n_words]) + "\n")
    cfg_dict = dict(recipe, data_dir=str(workdir / "corpus"),
                    output_dir=str(workdir / "run"), logging_steps=1,
                    save_steps=0, eval_steps=0,
                    watchdog_timeout_s=WATCHDOG_S)
    rows = pack_corpus(read_corpus(cfg_dict["data_dir"]), tok,
                       cfg_dict["max_length"])

    def new_trainer(model_seed):
        # max_steps stays 0: the schedule spans the recipe's epochs over
        # these rows, so every step after the first has a learning rate
        # above 0; the run is cut by the signal
        model = SpladeEncoder(model_config, device=device
                              ).init_weights(model_seed).mlm
        return MLMTrainer(MLMConfig(**cfg_dict), model, rows, tok,
                          device=device)

    trainer = new_trainer(seed)
    cfg = trainer.cfg
    n_params = sum(p.numel() for p in trainer.model.parameters())
    tokens_per_step = cfg.batch_size * cfg.grad_accum * cfg.max_length
    log(f"  {n_sentences} sentences packed into {len(rows)} rows of "
        f"{cfg.max_length} tokens ({len(trainer.val_rows)} held out); "
        f"{trainer.steps_per_epoch} steps an epoch of {cfg.batch_size} x "
        f"{cfg.grad_accum} rows, schedule of {trainer.total_steps} steps; "
        f"model {n_params / 1e6:.1f}M params (f32 master, {cfg.dtype} "
        f"compute, remat {model_config.remat}); set-up "
        f"{time.perf_counter() - t0:.1f} s")
    if trainer.total_steps < steps + 4:
        raise SystemExit("MLM corpus too small for the run")

    # one run: warm-up step, measured steps, SIGTERM during the next
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = {sig: signal.getsignal(sig)
              for sig in (signal.SIGTERM, signal.SIGINT)}
    replaced = trainer.install_preemption_handler()
    killer = _sigterm_after(trainer, 1 + steps)
    _reset_launch_counts()
    try:
        t0 = time.perf_counter()
        state = trainer.train()
        sync()
        run_s = time.perf_counter() - t0
        launches = _launch_counts()
        steps_run = state.step  # the warm-up step among them
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
    killer.join(timeout=30)
    restored = {sig: signal.getsignal(sig) for sig in before} == before
    peak_gb = (torch.cuda.max_memory_allocated() / 1e9
               if device == "cuda" else None)
    records = [json.loads(line) for line in
               (workdir / "run" / "metrics.jsonl").read_text().splitlines()]
    for r in records:
        log(f"  step {r['step']}{' (warm-up)' if r['step'] == 1 else ''}: "
            f"loss {r['loss']:.5f} acc {r['mlm_acc']:.4f} masked/row "
            f"{r['masked_per_row']:.1f} at {r['time']:.2f} s")
    ckpt = find_latest_checkpoint(str(workdir / "run"))
    wd = trainer._watchdog
    wd._thread.join(timeout=5.0)
    preempt = dict(preempted=trainer._preempted, stopped_at_step=state.step,
                   checkpoint=Path(ckpt).name if ckpt else None,
                   handlers_restored=restored, watchdog_beats=wd.beats,
                   watchdog_tripped=wd.tripped)
    log(f"  SIGTERM after step {1 + steps}'s record: run returned at step "
        f"{state.step} of {trainer.total_steps} in {run_s:.1f} s with "
        f"checkpoint {preempt['checkpoint']}; previous signal handlers "
        f"restored: {restored}; watchdog {wd.beats} beats, tripped "
        f"{wd.tripped}")
    if not (trainer._preempted and 1 + steps <= state.step
            < trainer.total_steps and ckpt
            and ckpt.endswith(f"step{state.step}") and restored
            and len(records) == state.step and not wd.tripped
            and not wd._thread.is_alive()
            and all(np.isfinite(r["loss"]) for r in records)):
        raise SystemExit("MLM: the run did not stop on SIGTERM at a step "
                         "boundary with a checkpoint")
    # the measured steps, from the trainer's own records (each written
    # after float(loss) returned, i.e. after the card finished the step)
    wall = records[steps]["time"] - records[0]["time"]
    step_ms = wall / steps * 1e3
    tokens_per_s = steps * tokens_per_step / wall
    log(f"  {steps} steps in {wall:.2f} s: {tokens_per_s:.0f} tokens/s, "
        f"{step_ms:.0f} ms a step of {tokens_per_step} tokens (warm-up "
        f"step {records[0]['time']:.1f} s after the tracker's start); peak "
        f"device memory "
        + (f"{peak_gb:.2f} GB ({gb_at_start:.2f} GB in use before the phase)"
           if peak_gb is not None else "not measured"))

    # the next step: live under the profiler, then resumed from the
    # checkpoint by a fresh trainer; both must be bitwise equal
    epoch = state.step // trainer.steps_per_epoch + 1
    at = state.step - (epoch - 1) * trainer.steps_per_epoch
    host = next(b for i, b in enumerate(trainer._epoch_batches(epoch))
                if i == at)
    dev_batch = {"input_ids": trainer._to_device(host["input_ids"])}
    lr_live = state.optimizer.param_groups[0]["lr"]
    box = {}
    if device == "cuda":
        prof = device_profile(torch, lambda: box.setdefault(
            "m", trainer.step_fn(state, dev_batch)))
        top = list(prof.get("top_kernels_ms", {}).items())
        log(f"  one step under torch.profiler: wall {prof['wall_ms']:.1f} ms"
            + (f", device busy {prof['device_busy_ms']:.1f} ms (idle "
               f"{prof['device_idle_share']:.1%}) over {prof['device_ops']} "
               "device ops; top: " + ", ".join(f"{k[:48]} {v:.2f}"
                                              for k, v in top[:6])
               if prof["device_busy_ms"] is not None
               else "; the profiler saw no device activity, not measured"))
    else:
        box["m"] = trainer.step_fn(state, dev_batch)
        prof = None
    live = {k: float(v) for k, v in box["m"].items()}
    fresh = new_trainer(seed + 1)
    fresh.state, meta = load_checkpoint(ckpt, fresh.state)
    pairs = list(zip(state.model.parameters(), fresh.state.model.parameters()))
    with torch.no_grad():
        moved = max(float((a - b).abs().max()) for a, b in pairs)
    lr_resumed = fresh.state.optimizer.param_groups[0]["lr"]
    resumed = {k: float(v) for k, v in
               fresh.step_fn(fresh.state, dev_batch).items()}
    bitwise = (all(torch.equal(a, b) for a, b in pairs)
               and resumed == live)
    resume = dict(full_resume=meta["full_resume"], step=fresh.state.step,
                  lr=lr_resumed, lr_live=lr_live, step_moved_params=moved,
                  bitwise=bitwise, loss_live=live["loss"],
                  loss_resumed=resumed["loss"])
    log(f"  resumed from {Path(ckpt).name}: step {fresh.state.step} at lr "
        f"{lr_resumed:.3e} (uninterrupted {lr_live:.3e}), which moved the "
        f"parameters by up to {moved:.2e}; loss {resumed['loss']:.6f} vs "
        f"uninterrupted {live['loss']:.6f}; metrics and parameters bitwise "
        f"equal: {bitwise}")
    if not (meta["full_resume"] and fresh.state.step == state.step
            and lr_resumed > 0 and lr_resumed == lr_live and moved > 0
            and bitwise):
        raise SystemExit("MLM: the resumed step differs from the "
                         "uninterrupted one")
    del fresh, pairs
    evaluation = trainer.evaluate()
    log(f"  held-out evaluation over {len(trainer.val_rows)} rows: "
        f"{evaluation}")
    if not (evaluation and np.isfinite(evaluation["mlm_loss"])):
        raise SystemExit("MLM: held-out evaluation gave nothing finite")
    attention = None
    if model_config.attention_impl == "splash":
        micro = {"input_ids": dev_batch["input_ids"][0]}
        attention = compare_attention_routes(
            torch, state.model, lambda: trainer.loss_fn(
                micro, torch.Generator(device=trainer.device).manual_seed(
                    seed))[0], "MLM")

    # final model -> from_checkpoint -> the in-memory weights' vectors ->
    # a served engine
    final = save_final_model(str(workdir / "run"), state.model, tok,
                             prefix="mlm.")
    enc = SparseEncoderV33.from_checkpoint(
        final, tok, device=device, config=checkpoint_config, query_top_k=64,
        doc_top_k=256)
    memory = SpladeEncoder(model_config, device=device)
    memory.mlm.load_state_dict(state.model.state_dict())
    mem = SparseEncoderV33(memory.to(torch.bfloat16), tok, device=device,
                           query_top_k=64, doc_top_k=256)
    queries = hangul_texts(rng, 8, 6)
    docs = hangul_texts(rng, 512, 60)
    worst = 0.0
    for texts, length in ((queries, enc.query_max_length),
                          (docs[:32], enc.doc_max_length)):
        got = enc.encode_tensor(*enc.tokenize(texts, length))
        want = mem.encode_tensor(*mem.tokenize(texts, length))
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-6)
        worst = max(worst, float(((got - want).abs() / scale).max()))
        if not (got.shape == (len(texts), V)
                and bool(torch.isfinite(got).all())):
            raise SystemExit("MLM: the loaded model's vectors are not "
                             "finite [B, V]")
    log(f"  final model -> SparseEncoderV33.from_checkpoint: 8 queries and "
        f"32 documents encode to the in-memory weights' vectors (bf16 cast "
        f"of the same weights), max relative diff {worst:.2e} (tol "
        f"{CHECKPOINT_RTOL})")
    if not worst <= CHECKPOINT_RTOL:
        raise SystemExit("MLM: from_checkpoint's vectors differ from the "
                         "in-memory model's")
    del mem, memory
    engine = build_engine_from_docs(
        enc.model, tok, [(f"doc{i}", t) for i, t in enumerate(docs)],
        int8=True, doc_top_k=256, index_type="dense", query_top_k=64,
        device=device)
    served = drive("pre-trained dense", engine, enc.model, queries, docs[5])
    del engine

    v2 = v2_path(torch, state.model, tok, rng, trainer._autocast, v2_shapes)
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(recipe=recipe, model_params=n_params, rows=len(rows),
                steps=[{k: r[k] for k in ("step", "loss", "mlm_acc",
                                          "masked_per_row", "time")}
                       for r in records],
                measured_steps=steps, wall_s=wall, tokens_per_s=tokens_per_s,
                step_ms=step_ms, tokens_per_step=tokens_per_step,
                peak_device_gb=peak_gb, device_gb_at_start=gb_at_start,
                remat=model_config.remat,
                preemption=preempt, profile=prof, profiled_step=live,
                resume=resume, evaluation=evaluation,
                from_checkpoint_max_rel_diff=worst, served=served,
                v2_path=v2, launches=launches, steps_run=steps_run,
                attention_route=attention)


# ------------------------------------------------------------ phase 7
#: every subprocess of phase 7 gets this long: a hung collective fails the
#: phase, not the run's clock
DP_TIMEOUT_S = 300.0
#: ranks of the data-parallel run that shares the one card (phase 7 (b))
DP_WORLD = 2
#: the bounds of the tolerance phase 7 (b) holds the ranks' emulation to
#: against one process at the global batch, both in f32: twice the noise
#: floor it measures first, within these. A wrong block mask or a lost
#: division moves the loss and the gradients by far more than the ceiling
DP_RTOL = (1e-5, 1e-3)
#: the keys of a step record that are times, not results of the step
TIME_KEYS = ("time", "samples_per_sec", "tokens_per_sec", "allreduce_ms",
             "epoch")


def launches_on(device: str, want: dict) -> dict:
    """The launches a run implies on ``device``: none off the card, where
    every wrapper runs its plain version."""
    return want if device.startswith("cuda") else dict.fromkeys(want, 0)


def state_digest(state: dict) -> str:
    """sha256 of named tensors' names and f32 bytes, in name order: two
    state dicts (or models' ``dict(named_parameters())``) have the same
    digest when every tensor is bitwise equal."""
    import hashlib

    digest = hashlib.sha256()
    for name in sorted(state):
        digest.update(name.encode())
        digest.update(state[name].detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def param_digest(model) -> str:
    return state_digest(dict(model.named_parameters()))


def repo_env(**extra) -> dict:
    """This environment with the checkout on PYTHONPATH, plus ``extra``."""
    root = str(Path(__file__).resolve().parent)
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=root + (os.pathsep + path if path
                                                else ""), **extra)


def run_processes(what: str, commands, envs, logs,
                  timeout_s: float = DP_TIMEOUT_S) -> list:
    """Start every command at once (output to its log file), wait for all
    under one deadline. A process still running at the deadline is killed
    with the others and the phase fails; so does one that exits non-zero.
    Returns the logs' texts."""
    procs = []
    try:
        for cmd, env, path in zip(commands, envs, logs):
            with open(path, "w") as out:
                procs.append(subprocess.Popen(cmd, stdout=out,
                                              stderr=subprocess.STDOUT,
                                              env=env))
        deadline = time.monotonic() + timeout_s
        for proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise SystemExit(f"{what}: still running after {timeout_s:.0f}"
                                 " s (a hung collective?); killed") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    texts = [Path(p).read_text() for p in logs]
    for proc, text in zip(procs, texts):
        if proc.returncode != 0:
            raise SystemExit(f"{what}: {' '.join(map(str, proc.args[:6]))} "
                             f"... exited {proc.returncode}:\n{text[-4000:]}")
    return texts


def accumulated_gradients(torch, model, runs) -> tuple:
    """One rank's part of a step before its reduction: the micro-batch
    closures ``runs`` (each -> (loss, metrics)) taken in order from no
    gradients, losses and metrics summed and gradients accumulated, all
    divided by their count. -> (metrics with "loss", {name: gradient})."""
    model.zero_grad(set_to_none=True)
    sums = {}
    for run in runs:
        loss, metrics = run()
        loss.backward()
        for k, v in {"loss": loss.detach(),
                     **{k: v.detach() for k, v in metrics.items()}}.items():
            sums[k] = v if k not in sums else sums[k] + v
    grads = {n: p.grad.div_(len(runs)) for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: v / len(runs) for k, v in sums.items()}, grads


def combined_gradients(torch, model, rank_runs) -> tuple:
    """The ranks' reduction taken in one process: each rank's part in turn
    (``accumulated_gradients``), gradients and metrics combined as
    (x0 + x1 + ...) / W in rank order. At W = 2 these are the bits of the
    SUM all-reduce divided by 2. -> (metrics, {name: gradient})."""
    parts = [accumulated_gradients(torch, model, runs) for runs in rank_runs]
    world = len(parts)

    def mean(values):
        total = values[0]
        for v in values[1:]:
            total = total + v
        return total / world

    return ({k: mean([m[k] for m, _ in parts]) for k in parts[0][0]},
            {n: mean([g[n] for _, g in parts]) for n in parts[0][1]})


def emulate_ranks_step(torch, state, clip: float, rank_runs) -> dict:
    """One optimizer step of ``len(rank_runs)`` data-parallel ranks taken in
    one process, the reference phase 7 holds the ranks to: the combined
    gradients (``combined_gradients``) clipped, one AdamW and schedule
    step. -> the metrics as floats, the clipped norm's mean over ranks among
    them."""
    model = state.model
    model.train()
    metrics, grads = combined_gradients(torch, model, rank_runs)
    params = dict(model.named_parameters())
    for name, g in grads.items():
        params[name].grad = g
    grad_norm = torch.nn.utils.clip_grad_norm_([params[n] for n in grads],
                                               clip)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    out = {k: float(v) for k, v in metrics.items()}
    total = grad_norm
    for _ in rank_runs[1:]:
        total = total + grad_norm
    out["grad_norm"] = float(total / len(rank_runs))
    return out


def v33_runs(torch, model, cfg, macro, step: int, num_blocks: int = 1):
    """The micro-batch closures of a V33 step on ``macro`` ([accum, B, ...]
    device tensors), the trainer's loss with ``num_blocks``."""
    from splade_tpu_torch.train.trainer import compute_autocast, make_loss_fn

    dev = next(model.parameters()).device
    loss_fn = make_loss_fn(model, cfg.loss, num_blocks,
                           packed_query=cfg.model.packed_query_tower,
                           autocast=lambda: compute_autocast(cfg.model, dev))

    def run(i):
        def go():
            loss, metrics = loss_fn({k: v[i] for k, v in macro.items()}, step)
            return loss, metrics.as_dict()
        return go

    return [run(i) for i in range(next(iter(macro.values())).shape[0])]


def mlm_runs(torch, loss_fn, rank_ids, seed: int, step: int):
    """Per rank, the micro-batch closures of an MLM step (``rank_ids[r]``:
    rank r's [accum, B, S] device ids): the masks drawn over the global
    micro-batch, each rank normalised by the global count of masked
    positions, summed over ranks in rank order, as the all-reduce sums."""
    from splade_tpu_torch.train.mlm import mask_seed

    world = len(rank_ids)
    dev = rank_ids[0].device

    def gen(i):
        return torch.Generator(device=dev).manual_seed(mask_seed(seed, step,
                                                                  i))

    totals = []
    for i in range(rank_ids[0].shape[0]):
        counts = [loss_fn.mask({"input_ids": ids[i]}, gen(i), world, r)[4]
                  .sum() for r, ids in enumerate(rank_ids)]
        total = counts[0]
        for c in counts[1:]:
            total = total + c
        totals.append(total)

    def run(r, i):
        return lambda: loss_fn({"input_ids": rank_ids[r][i]}, gen(i),
                               count=lambda t: totals[i], world=world, rank=r)

    return [[run(r, i) for i in range(len(totals))] for r in range(world)]


def rank_macro_batches(torch, data, collator, batch: int, seed: int,
                       accum: int, steps: int, world: int, device) -> list:
    """[step][rank] -> that rank's macro batch as the Trainer's loader gives
    it (its slice of the epoch's order, ``batch`` rows a micro-batch), on
    ``device``."""
    from splade_tpu_torch.data.pipeline import create_dataloader
    from splade_tpu_torch.train.trainer import (pin_batch, stack_microbatches,
                                                to_device)

    out = [[None] * world for _ in range(steps)]
    for r in range(world):
        loader = create_dataloader(data, collator, batch, shuffle=True,
                                   seed=seed, drop_last=True, process_index=r,
                                   process_count=world, prefetch_depth=0)
        loader.set_epoch(1)
        micro = []
        for mb in loader:
            micro.append(mb)
            if len(micro) == accum * steps:
                break
        for s in range(steps):
            host = stack_microbatches(micro[s * accum:(s + 1) * accum])
            out[s][r] = to_device(pin_batch(host, False), torch.device(device))
    return out


def gradients_against(torch, got, want, what: str, bounds=None,
                      floor=None) -> dict:
    """Loss, the gradients' global norm and every gradient tensor
    (norm-relative) of ``got`` = (metrics, grads) against ``want``. With
    ``bounds`` the tolerance is twice ``floor``'s error (its own
    comparison's result), within the bounds; without, the result is
    returned unjudged (a floor)."""
    (g_m, g_g), (w_m, w_g) = got, want
    norm = lambda grads: float(torch.sqrt(sum((g.float() ** 2).sum()
                                              for g in grads.values())))
    loss_err = abs(float(g_m["loss"]) - float(w_m["loss"])) / max(
        abs(float(w_m["loss"])), 1e-30)
    g_norm, w_norm = norm(g_g), norm(w_g)
    norm_err = abs(g_norm - w_norm) / max(w_norm, 1e-30)
    tensor_err = {n: float((g_g[n].float() - w_g[n].float()).norm()
                           / w_g[n].float().norm().clamp_min(1e-30))
                  if n in g_g else 1.0 for n in w_g}
    worst = max(tensor_err, key=tensor_err.get)
    out = dict(loss=float(g_m["loss"]), loss_ref=float(w_m["loss"]),
               loss_rel_err=loss_err, grad_norm=g_norm, grad_norm_ref=w_norm,
               grad_norm_rel_err=norm_err, worst_tensor=worst,
               worst_tensor_rel_err=tensor_err[worst], tensors=len(w_g))
    if bounds is None:
        return out
    least, most = bounds
    tol = {k: min(max(2 * floor[k], least), most)
           for k in ("loss_rel_err", "grad_norm_rel_err",
                     "worst_tensor_rel_err")}
    out.update(tolerance=tol, noise_floor={k: floor[k] for k in tol})
    log(f"  {what}: loss {out['loss']:.6f} vs {out['loss_ref']:.6f} (rel "
        f"{loss_err:.2e}, tol {tol['loss_rel_err']:.2e}), grad_norm "
        f"{g_norm:.6f} vs {w_norm:.6f} (rel {norm_err:.2e}, tol "
        f"{tol['grad_norm_rel_err']:.2e}), worst of {len(w_g)} gradients "
        f"{worst} {tensor_err[worst]:.2e} (tol "
        f"{tol['worst_tensor_rel_err']:.2e}); noise floor "
        + ", ".join(f"{k} {v:.2e}" for k, v in out["noise_floor"].items()))
    if not all(out[k] <= tol[k] for k in tol):
        raise SystemExit(f"{what}: the data-parallel step differs from one "
                         "process at the global batch")
    return out


def dp_worker(spec_path: str) -> int:
    """One rank of phase 7 (b): ``python chip_smoke.py --dp-worker SPEC``
    with RANK, WORLD_SIZE and LOCAL_RANK set, every rank on the spec's
    device over gloo. Four runs through the entry points, from the seed's
    weights: V33 ``steps`` steps through ``Trainer`` (each step's metrics,
    all-reduce ms and the kernels' launches; then a checkpoint written to a
    directory of this rank's name, which only rank 0 may create), V33 again
    with SIGTERM sent to the last rank during its second step, one V33 step
    with global in-batch negatives, and MLM ``steps`` steps through
    ``MLMTrainer``. Writes ``rank{R}.json`` beside the spec. The metric
    writer keeps its JSONL sink only, as in ``cli_entry``."""
    sys.modules["torch.utils.tensorboard"] = None
    import torch
    import torch.distributed as dist

    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.parallel.mesh import agree_any, init_distributed
    from splade_tpu_torch.train.checkpoint import save_checkpoint
    from splade_tpu_torch.train.mlm import MLMConfig, MLMTrainer
    from splade_tpu_torch.train.trainer import Trainer

    global V
    spec = json.loads(Path(spec_path).read_text())
    V = spec["vocab"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = spec["device"]
    out = Path(spec_path).parent
    mesh = init_distributed(device, backend="gloo",
                            init_method=spec["init_method"])
    rank = mesh.rank
    log(f"rank {rank} of {mesh.world} joined over {mesh.backend} on {device}")
    tok = CharTokenizer()
    data = load_training_data(spec["train_files"])
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else (lambda: None))

    def v33_trainer(run: str, cfg_dict: dict):
        cfg = V33Config.from_dict(json.loads(json.dumps(cfg_dict)))
        cfg.training.output_dir = str(out / f"{run}_rank{rank}")
        collator = TripletCollator(
            tok, query_max_length=cfg.data.query_max_length,
            doc_max_length=cfg.data.doc_max_length,
            num_hard_negatives=cfg.data.num_hard_negatives)
        model = SpladeEncoder(ModernBertConfig(**spec["v33_model"]),
                              pool_impl="kernel", with_token_weights=False,
                              device=device).init_weights(spec["seed"])
        return Trainer(cfg, model, data, collator, device=device, mesh=mesh)

    def recorded(trainer):
        """Every step's metrics as floats, and the all-reduce's ms."""
        records, ms = [], []
        real = trainer.step_fn

        def step(state, batch):
            metrics = real(state, batch)
            records.append({k: float(v) for k, v in metrics.items()})
            ms.append(trainer.reducer.last_ms)
            log(f"rank {rank}: step {state.step} loss {records[-1]['loss']}"
                f", all-reduce {ms[-1]:.1f} ms")
            return metrics

        trainer.step_fn = step
        return records, ms

    def free(*objs):
        del objs
        import gc

        gc.collect()
        if device.startswith("cuda"):
            torch.cuda.empty_cache()

    result = dict(rank=rank, world=mesh.world, backend=mesh.backend,
                  device=device)
    # 1. V33: the recipe's steps, then a checkpoint only rank 0 writes
    log(f"rank {rank}: V33 run")
    trainer = v33_trainer("v33", spec["v33"])
    result["digest_init"] = param_digest(trainer.model)
    result["total_steps"] = trainer.total_steps
    trainer.cfg.training.max_steps = spec["steps"]
    records, ms = recorded(trainer)
    _reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    state = trainer.train()
    sync()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    save_checkpoint(str(out / f"ckpt_rank{rank}"), state, trainer.cfg, epoch=1,
                    mesh=mesh)
    result["v33"] = dict(records=records, allreduce_ms=ms, launches=launches,
                         wall_s=wall, step=state.step,
                         digest=param_digest(state.model))
    t0 = time.perf_counter()
    for _ in range(100):
        agree_any(False, mesh)
    result["agree_ms"] = (time.perf_counter() - t0) * 10
    free(trainer, state)
    # 2. SIGTERM reaches the last rank only, during the second step
    log(f"rank {rank}: SIGTERM run")
    trainer = v33_trainer("sigterm", spec["v33"])
    trainer.cfg.training.max_steps = spec["steps"] + 1
    replaced = trainer.install_preemption_handler()
    real = trainer.step_fn

    def step_then_signal(state, batch):
        if rank == mesh.world - 1 and state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(state, batch)

    trainer.step_fn = step_then_signal
    try:
        state = trainer.train()
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
    result["sigterm"] = dict(step=state.step, preempted=trainer._preempted)
    free(trainer, state)
    # 3. one step with every rank's positives as candidates, in f32 (the
    # comparison with one process at the global batch is made in f32)
    log(f"rank {rank}: global-negatives step")
    cfg_dict = json.loads(json.dumps(spec["v33"]))
    cfg_dict["loss"]["global_in_batch_negatives"] = True
    cfg_dict["model"]["dtype"] = "float32"
    trainer = v33_trainer("global", cfg_dict)
    trainer.cfg.training.max_steps = 1
    records, _ = recorded(trainer)
    trainer.train()
    result["global_negatives"] = records
    free(trainer)
    # 4. MLM
    log(f"rank {rank}: MLM run")
    model = SpladeEncoder(ModernBertConfig(**spec["mlm_model"]),
                          device=device).init_weights(spec["seed"]).mlm
    trainer = MLMTrainer(
        MLMConfig(**dict(spec["mlm"], output_dir=str(out / f"mlm_rank{rank}"))),
        model, np.load(spec["mlm_rows"]), tok, device=device, mesh=mesh)
    result["mlm_digest_init"] = param_digest(trainer.model)
    trainer.cfg.max_steps = spec["steps"]
    records, ms = recorded(trainer)
    _reset_launch_counts()
    state = trainer.train()
    result["mlm"] = dict(records=records, allreduce_ms=ms,
                         launches=_launch_counts(), step=state.step,
                         digest=param_digest(state.model))
    free(trainer, state)
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def data_parallel_phase(torch, tok, rng, workdir, seed: int, recipe: dict,
                        v33_model, mlm_recipe_: dict, mlm_model,
                        device: str = "cuda", steps: int = 2,
                        n_sentences: int = 4000, sentence_words=(12, 28),
                        worker=None, timeout_s: float = DP_TIMEOUT_S) -> dict:
    """Phase 7 (b): ``DP_WORLD`` ranks, each its own process on ``device``
    (one card: every rank on it) over gloo, run ``dp_worker`` on half of
    the recipes' per-step batches, so the global batches are the recipes'.
    Held: the ranks' metrics identical across ranks and, with their
    parameters (digests), bitwise equal to the same halves taken in turn in
    this process (``emulate_ranks_step``), V33 and MLM; the launch counts
    each rank's run implies; rank 0's checkpoint the only one; after
    SIGTERM to the last rank, every rank stopped at the same step with one
    checkpoint (rank 0's). Then, in f32, the emulation's first step against
    one process at the global batch with num_blocks = DP_WORLD, and the
    ranks' step with global in-batch negatives against one process with
    them, to
    twice a noise floor measured first: that process's gradient with the
    step's micro-batches taken as one, their blocks masked apart.
    ``worker``: the command that starts a rank (default this script's
    ``--dp-worker``)."""
    import shutil

    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.mlm import (MLMConfig, MLMTrainer,
                                            pack_corpus, read_corpus)
    from splade_tpu_torch.train.state import create_train_state

    world = DP_WORLD
    workdir = Path(workdir).resolve()  # the group's file:// address
    shutil.rmtree(workdir, ignore_errors=True)
    (workdir / "corpus").mkdir(parents=True)
    v33 = json.loads(json.dumps(recipe))
    v33["data"]["batch_size"] //= world
    v33["data"]["train_files"] = [str(workdir / "train_*.jsonl")]
    v33["data"]["val_files"] = []
    v33["training"].update(log_every_n_steps=1)
    batch = v33["data"]["batch_size"]
    accum = v33["training"]["gradient_accumulation_steps"]
    with open(workdir / "train_000.jsonl", "w", encoding="utf-8") as f:
        for row in synth_triplets(rng, batch * world * accum * (steps + 1)):
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    mlm = dict(mlm_recipe_, batch_size=mlm_recipe_["batch_size"] // world,
               data_dir=str(workdir / "corpus"), logging_steps=1,
               save_steps=0, eval_steps=0, val_fraction=0.0)
    lo, hi = sentence_words
    cuts = rng.integers(lo, hi, n_sentences)
    with open(workdir / "corpus" / "mlm_000.txt", "w", encoding="utf-8") as f:
        for text, n_words in zip(hangul_texts(rng, n_sentences, hi - 1), cuts):
            f.write(" ".join(text.split(" ")[:n_words]) + "\n")
    rows = pack_corpus(read_corpus(mlm["data_dir"]), tok, mlm["max_length"])
    np.save(workdir / "mlm_rows.npy", rows)
    # every rank on the one card: an explicit index, which LOCAL_RANK
    # does not override
    rank_device = "cuda:0" if device == "cuda" else device
    spec = dict(vocab=V, seed=seed, device=rank_device, steps=steps,
                init_method=f"file://{workdir / 'process_group'}",
                train_files=v33["data"]["train_files"], v33=v33,
                v33_model=dataclasses.asdict(v33_model), mlm=mlm,
                mlm_model=dataclasses.asdict(mlm_model),
                mlm_rows=str(workdir / "mlm_rows.npy"))
    spec_path = workdir / "spec.json"
    spec_path.write_text(json.dumps(spec))
    worker = worker or [sys.executable, str(Path(__file__).resolve()),
                        "--dp-worker"]
    t0 = time.perf_counter()
    run_processes("data-parallel ranks",
                  [worker + [str(spec_path)]] * world,
                  [repo_env(RANK=str(r), WORLD_SIZE=str(world),
                            LOCAL_RANK=str(r)) for r in range(world)],
                  [workdir / f"rank{r}.log" for r in range(world)], timeout_s)
    ranks_s = time.perf_counter() - t0
    res = [json.loads((workdir / f"rank{r}.json").read_text())
           for r in range(world)]
    v33_runs_, mlm_runs_ = ([r["v33"] for r in res], [r["mlm"] for r in res])
    log(f"  {world} ranks on {device} over {res[0]['backend']} in "
        f"{ranks_s:.1f} s; gradient all-reduce ms a step, V33 "
        + ", ".join(f"rank {r}: {x['allreduce_ms']}" for r, x in
                    enumerate(v33_runs_))
        + f"; MLM rank 0: {mlm_runs_[0]['allreduce_ms']}; host agreement "
        f"on a stop flag {res[0]['agree_ms']:.4f} ms a call")

    # the process rules: identical logs, one writer, one stop step
    checks = {
        "V33 metrics identical across ranks":
            all(x["records"] == v33_runs_[0]["records"] for x in v33_runs_),
        "MLM metrics identical across ranks":
            all(x["records"] == mlm_runs_[0]["records"] for x in mlm_runs_),
        "parameters identical across ranks":
            len({x["digest"] for x in v33_runs_}) == 1
            and len({x["digest"] for x in mlm_runs_}) == 1,
        "global-negative metrics identical across ranks":
            all(r["global_negatives"] == res[0]["global_negatives"]
                for r in res),
        "checkpoints: rank 0's only, nothing written by another rank":
            any((workdir / "ckpt_rank0").glob("checkpoint_*"))
            and not [p.name for r in range(1, world)
                     for p in workdir.glob(f"*_rank{r}")],
        f"SIGTERM to rank {world - 1}: every rank stopped at step 2":
            all(r["sigterm"] == {"step": 2, "preempted": True} for r in res),
        "SIGTERM: one checkpoint, rank 0's":
            [p.name for p in (workdir / "sigterm_rank0").glob("checkpoint_*")]
            == ["checkpoint_epoch1_step2"],
    }
    for what, runs, want in (
            ("V33", v33_runs_, expected_launches(v33_model, accum, steps, 2)),
            ("MLM", mlm_runs_, expected_launches(mlm_model, mlm["grad_accum"],
                                                 steps, 0))):
        want = launches_on(device, want)
        for r, x in enumerate(runs):
            checks[f"rank {r} {what} launches {x['launches']} == {want}"] = (
                x["launches"] == want)

    # the emulation: the same halves in turn in this process
    data = load_training_data(v33["data"]["train_files"])
    cfg = V33Config.from_dict(json.loads(json.dumps(v33)))
    collator = TripletCollator(
        tok, query_max_length=cfg.data.query_max_length,
        doc_max_length=cfg.data.doc_max_length,
        num_hard_negatives=cfg.data.num_hard_negatives)
    macros = rank_macro_batches(torch, data, collator, batch,
                                cfg.training.seed, accum, steps, world, device)
    model = SpladeEncoder(v33_model, pool_impl="kernel",
                          with_token_weights=False,
                          device=device).init_weights(seed)
    checks["V33 same start"] = param_digest(model) == res[0]["digest_init"]
    joined = {k: torch.cat([m[k] for m in macros[0]], dim=1)
              for k in macros[0][0]}
    # one process at the global batch: the floor first, then the emulation
    # and the ranks' global negatives against it, all with autocast off
    # (f32): under bf16 autocast each micro-batch's weight gradients are
    # rounded to bf16 before they are summed, a noise that would hide a
    # fault of half a percent; in f32 the halves and the global batch differ
    # by the rounding of products and reductions over other row counts
    # alone
    f32 = V33Config.from_dict(json.loads(json.dumps(v33)))
    f32.model.dtype = "float32"
    at_global = accumulated_gradients(
        torch, model, v33_runs(torch, model, f32, joined, 0, num_blocks=world))
    # the floor: the same function at other shapes, the step's accum
    # micro-batches taken as one (its world x accum blocks, each a rank's
    # rows of a micro-batch, masked apart). A norm's weight gradient sums
    # over every row, in an order set by the row count, and cancels: in
    # f32 it moves by about 1e-4 between row counts on an H100, where the
    # same count with other rows in it moves it by 1e-6
    whole = {k: v.reshape(1, accum * v.shape[1], *v.shape[2:])
             for k, v in joined.items()}
    floor = gradients_against(torch, accumulated_gradients(
        torch, model, v33_runs(torch, model, f32, whole, 0,
                               num_blocks=world * accum)), at_global,
        "noise floor")
    emulated = combined_gradients(torch, model, [
        v33_runs(torch, model, f32, m, 0) for m in macros[0]])
    vs_global = gradients_against(
        torch, emulated, at_global,
        f"V33 two halves (num_blocks 1 each) vs one process at the global "
        f"batch (num_blocks {world}), first step, f32", DP_RTOL, floor)
    gcfg = V33Config.from_dict(json.loads(json.dumps(v33)))
    gcfg.model.dtype = "float32"
    gcfg.loss.global_in_batch_negatives = True
    g_metrics, g_grads = accumulated_gradients(
        torch, model, v33_runs(torch, model, gcfg, joined, 0,
                               num_blocks=world))
    g_norm = float(torch.sqrt(sum((g.float() ** 2).sum()
                                  for g in g_grads.values())))
    ranks_g = res[0]["global_negatives"][0]
    global_neg = dict(loss=ranks_g["loss"], loss_ref=float(g_metrics["loss"]),
                      grad_norm=ranks_g["grad_norm"], grad_norm_ref=g_norm)
    global_neg["loss_rel_err"] = abs(global_neg["loss"] - global_neg[
        "loss_ref"]) / abs(global_neg["loss_ref"])
    global_neg["grad_norm_rel_err"] = abs(g_norm - ranks_g["grad_norm"]) / g_norm
    gtol = {k: min(max(2 * floor[k], DP_RTOL[0]), DP_RTOL[1])
            for k in ("loss_rel_err", "grad_norm_rel_err")}
    log(f"  V33 global in-batch negatives, {world} ranks (every rank's "
        f"positives gathered) vs one process at the global batch: loss "
        f"{global_neg['loss']:.6f} vs {global_neg['loss_ref']:.6f} (rel "
        f"{global_neg['loss_rel_err']:.2e}, tol {gtol['loss_rel_err']:.2e}), "
        f"grad_norm {ranks_g['grad_norm']:.6f} vs {g_norm:.6f} (rel "
        f"{global_neg['grad_norm_rel_err']:.2e}, tol "
        f"{gtol['grad_norm_rel_err']:.2e})")
    checks["global negatives within tolerance"] = all(
        global_neg[k] <= gtol[k] for k in gtol)
    del at_global, emulated, g_grads

    state = create_train_state(model, cfg.training, res[0]["total_steps"])
    emulation = []
    for s in range(steps):
        emulation.append(emulate_ranks_step(
            torch, state, cfg.training.gradient_clip,
            [v33_runs(torch, model, cfg, m, state.step) for m in macros[s]]))
    v33_digest = param_digest(model)
    checks["V33 ranks == emulation (metrics, bitwise)"] = (
        [{k: r[k] for k in e} for r, e in
         zip(v33_runs_[0]["records"], emulation)] == emulation)
    checks["V33 ranks == emulation (parameters, bitwise)"] = (
        v33_runs_[0]["digest"] == v33_digest)
    log("  V33 steps, rank 0 | emulation: " + "; ".join(
        f"loss {r['loss']!r} | {e['loss']!r}, grad_norm {r['grad_norm']!r} | "
        f"{e['grad_norm']!r}" for r, e in zip(v33_runs_[0]["records"],
                                             emulation)))
    del model, state, macros, joined

    mcfg = MLMConfig(**dict(mlm, batch_size=mlm["batch_size"] * world,
                            output_dir=str(workdir / "mlm_emulation")))
    mlm_model_ = SpladeEncoder(mlm_model, device=device).init_weights(seed).mlm
    trainer = MLMTrainer(mcfg, mlm_model_, rows, tok, device=device)
    checks["MLM same start"] = (param_digest(trainer.model)
                                == res[0]["mlm_digest_init"])
    mlm_emulation = []
    for s, host in zip(range(steps), trainer._epoch_batches(1)):
        ids = trainer._to_device(host["input_ids"])
        b = mlm["batch_size"]
        rank_ids = [ids[:, r * b:(r + 1) * b] for r in range(world)]
        mlm_emulation.append(emulate_ranks_step(
            torch, trainer.state, 1.0,
            mlm_runs(torch, trainer.loss_fn, rank_ids, mcfg.seed,
                     trainer.state.step)))
    mlm_digest = param_digest(trainer.model)
    checks["MLM ranks == emulation (metrics, bitwise)"] = (
        [{k: r[k] for k in r} for r in mlm_runs_[0]["records"]]
        == [{k: e[k] for k in r} for r, e in zip(mlm_runs_[0]["records"],
                                                 mlm_emulation)])
    checks["MLM ranks == emulation (parameters, bitwise)"] = (
        mlm_runs_[0]["digest"] == mlm_digest)
    log("  MLM steps, rank 0 | emulation: " + "; ".join(
        f"loss {r['loss']!r} | {e['loss']!r}" for r, e in
        zip(mlm_runs_[0]["records"], mlm_emulation)))
    del trainer
    failed = [k for k, ok in checks.items() if not ok]
    for k, ok in checks.items():
        log(f"  {'ok' if ok else 'FAILED'}: {k}")
    if failed:
        raise SystemExit(f"data-parallel phase: {failed}")
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(world=world, backend=res[0]["backend"], device=device,
                ranks_s=ranks_s, steps=steps,
                v33=dict(records=v33_runs_[0]["records"],
                         allreduce_ms=[x["allreduce_ms"] for x in v33_runs_],
                         launches=[x["launches"] for x in v33_runs_],
                         wall_s=[x["wall_s"] for x in v33_runs_]),
                mlm=dict(records=mlm_runs_[0]["records"],
                         allreduce_ms=[x["allreduce_ms"] for x in mlm_runs_],
                         launches=[x["launches"] for x in mlm_runs_]),
                agree_ms=[r["agree_ms"] for r in res],
                vs_global_batch=vs_global, global_negatives=global_neg,
                checks=list(checks))


def cli_entry(argv) -> int:
    """``python chip_smoke.py --cli [--model-config JSON] {v33,mlm} ARGS``:
    the port's training CLI (``python -m splade_tpu_torch.train``) with
    this script's stand-in tokenizer in place of ``create_tokenizer`` (the
    card machine has no transformers) and, where given, a model config's
    fields over the architecture's (the CPU rehearsal's tiny model). Phase
    7 starts it alone and under ``torch.distributed.run``; its last line
    is the kernels' launch counts of the run, ``LAUNCHES {...}``. The
    metric writer keeps its JSONL sink only (TensorBoard, which the card
    machine lacks, imports TensorFlow where it is installed)."""
    sys.modules["torch.utils.tensorboard"] = None
    import torch

    from splade_tpu_torch.models import modernbert
    from splade_tpu_torch.train import cli, mlm
    from splade_tpu_torch.utils import tokenizer

    global V
    over = {}
    if argv[0] == "--model-config":
        over, argv = json.loads(argv[1]), argv[2:]
        V = over.get("vocab_size", V)
    tok = CharTokenizer()
    cli.create_tokenizer = tokenizer.create_tokenizer = lambda *a, **k: tok
    if over:
        architecture = modernbert.ModernBertConfig
        modernbert.ModernBertConfig = lambda **kw: architecture(
            **{**kw, **over})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sub, rest = argv[0], argv[1:]
    rc = (cli.main if sub == "v33" else mlm.main)(rest)
    print("LAUNCHES " + json.dumps(_launch_counts()), flush=True)
    return rc




def cli_world1(torch, what: str, sub: str, workdir: Path, args: list,
               env: dict, model_over, rate_per_step: int,
               timeout_s: float) -> dict:
    """The CLI ``sub`` run twice from the same arguments: as one process,
    then as rank 0 of a world of 1 (``torch.distributed.run --standalone
    --nproc_per_node 1 ... --distributed``, NCCL on the card). Held: every
    logged step's results (times aside) and the final model bitwise equal.
    -> both runs' records, launches, digests, and the world-1 run's
    all-reduce ms and rate."""
    script = str(Path(__file__).resolve())
    head = [script, "--cli"] + (["--model-config", json.dumps(model_over)]
                                if model_over else [])
    runs = {}
    for name, launcher, flag in (
            ("single", [sys.executable], []),
            ("world1", [sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", "1"],
             ["--distributed"])):
        out = workdir / name
        t0 = time.perf_counter()
        text = run_processes(
            f"{what} ({name})",
            [launcher + head + [sub] + flag + args + ["--output-dir",
                                                      str(out)]],
            [repo_env(**env)], [workdir / f"{name}.log"], timeout_s)[0]
        seconds = time.perf_counter() - t0
        records = [json.loads(line) for line in
                   (out / "metrics.jsonl").read_text().splitlines()]
        launches = json.loads([line for line in text.splitlines()
                               if line.startswith("LAUNCHES ")][-1][9:])
        state = torch.load(out / "final_model" / "model.pt",
                           map_location="cpu", weights_only=True)
        times = [r["time"] for r in records]
        runs[name] = dict(
            records=records, launches=launches, state=state,
            digest=state_digest(state), seconds=seconds,
            per_s=(rate_per_step * (len(times) - 1) / (times[-1] - times[0])
                   if len(times) > 1 else None))
    one, dp = runs["single"], runs["world1"]
    strip = lambda rs: [{k: v for k, v in r.items() if k not in TIME_KEYS}
                        for r in rs]
    same_records = strip(one["records"]) == strip(dp["records"])
    same_model = (one["state"].keys() == dp["state"].keys()
                  and all(torch.equal(one["state"][k], dp["state"][k])
                          for k in one["state"]))
    reduce_ms = [r.get("allreduce_ms") for r in dp["records"]]
    log(f"  {what}: {len(dp['records'])} steps, losses one process "
        f"{[r['loss'] for r in one['records']]} | world 1 "
        f"{[r['loss'] for r in dp['records']]}: bitwise equal "
        f"{same_records}; final model digests {one['digest'][:16]} | "
        f"{dp['digest'][:16]}: bitwise equal {same_model}; gradient "
        f"all-reduce ms a step {reduce_ms}; "
        + (f"{dp['per_s']:.1f} vs {one['per_s']:.1f} a second over the "
           "steps after the first (world 1 | one process); "
           if dp["per_s"] else "")
        + f"launches {dp['launches']}; wall {one['seconds']:.1f} | "
        f"{dp['seconds']:.1f} s a run")
    if not (same_records and same_model and all(
            ms is not None for ms in reduce_ms)):
        raise SystemExit(f"{what}: the world-1 run differs from one process")
    for run in runs.values():
        del run["state"]
    return dict(runs, allreduce_ms=reduce_ms)


def v33_cli_phase(torch, rng, workdir, recipe: dict, model_config,
                  device: str = "cuda", steps: int = 3, model_over=None,
                  timeout_s: float = DP_TIMEOUT_S) -> dict:
    """Phase 7 (a): the V33 CLI on the recipe (its config written as JSON,
    which the CLI reads without PyYAML) and synthetic JSONL triplets,
    ``steps`` steps, one process against a world of 1 over NCCL
    (``cli_world1``); each pool kernel launched 2 x accumulation a step."""
    import shutil

    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    cfg = json.loads(json.dumps(recipe))
    batch = cfg["data"]["batch_size"]
    accum = cfg["training"]["gradient_accumulation_steps"]
    with open(workdir / "train_000.jsonl", "w", encoding="utf-8") as f:
        for row in synth_triplets(rng, batch * accum * steps):
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    cfg["data"].update(train_files=[str(workdir / "train_*.jsonl")],
                       val_files=[])
    cfg["training"].update(log_every_n_steps=1, max_steps=steps)
    (workdir / "config.json").write_text(json.dumps(cfg))
    args = ["--config", str(workdir / "config.json")] + (
        ["--device", "cpu"] if device == "cpu" else [])
    out = cli_world1(torch, "V33 CLI", "v33", workdir, args, {}, model_over,
                     batch * accum, timeout_s)
    want = launches_on(device, expected_launches(model_config, accum, steps,
                                                 2))
    for name in ("single", "world1"):
        hold_launches(f"V33 CLI ({name})", out[name]["launches"], want)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def mlm_cli_phase(torch, rng, workdir, recipe: dict, device="cuda",
                  steps: int = 2, n_sentences: int = 4000,
                  sentence_words=(12, 28), env_over=None, model_over=None,
                  timeout_s: float = DP_TIMEOUT_S) -> dict:
    """Phase 7 (c): ``python -m splade_tpu_torch.train mlm`` on the recipe
    (the configuration's defaults, which the recipe is; ``MLM_*`` overrides
    for logging every step) over a synthetic corpus, ``steps`` steps, one
    process against a world of 1 over NCCL (``cli_world1``)."""
    import shutil

    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    (workdir / "corpus").mkdir(parents=True)
    lo, hi = sentence_words
    cuts = rng.integers(lo, hi, n_sentences)
    with open(workdir / "corpus" / "mlm_000.txt", "w", encoding="utf-8") as f:
        for text, n_words in zip(hangul_texts(rng, n_sentences, hi - 1), cuts):
            f.write(" ".join(text.split(" ")[:n_words]) + "\n")
    env = {"MLM_LOGGING_STEPS": "1", "MLM_SAVE_STEPS": "0",
           "MLM_EVAL_STEPS": "0", **(env_over or {})}
    args = ["--data-dir", str(workdir / "corpus"), "--max-steps",
            str(steps)] + (["--device", "cpu"] if device == "cpu" else [])
    tokens = (int(env.get("MLM_BATCH_SIZE", recipe["batch_size"]))
              * int(env.get("MLM_GRAD_ACCUM", recipe["grad_accum"]))
              * int(env.get("MLM_MAX_LENGTH", recipe["max_length"])))
    out = cli_world1(torch, "MLM CLI", "mlm", workdir, args, env, model_over,
                     tokens, timeout_s)
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import fused_splade_pool
    from splade_tpu_torch.ops.postings_index import PostingsIndex
    from splade_tpu_torch.ops.rescore_kernel import rescore_match
    from splade_tpu_torch.serving.engine import (ServingEngine,
                                                 build_engine_from_docs)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"tf32 matmul off")

    # ---- 1. build
    t0 = time.perf_counter()
    _cuda.library()
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s "
        f"(sources {[s.name for s in _cuda.sources()]})")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())
    ptxas = ptxas_summary(_cuda.build_log())
    for name in REDESIGNED:
        for rep in ptxas[name]:
            log(f"  {name}: {rep['registers']} registers, "
                f"{rep['static_smem_bytes']} B static shared memory (the "
                f"rest is dynamic), {rep['stack_bytes']} B stack, spills "
                f"{rep['spill_store_bytes']} B stored / "
                f"{rep['spill_load_bytes']} B loaded")

    rng = np.random.default_rng(args.seed)
    tok = CharTokenizer()
    log("tokenizer: a deterministic character-level stand-in defined in "
        "chip_smoke.py (the A.X-Encoder tokenizer is not in the repository)")
    model = SpladeEncoder(ModernBertConfig(), pool_impl="kernel",
                          device="cuda").init_weights(args.seed)
    model = model.to(torch.bfloat16).eval()
    log(f"model: SpladeEncoder 22L/768/50K, seeded random weights "
        f"(seed {args.seed}), bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params")

    # ---- 2. kernels against their plain versions
    log("[2] kernels vs plain versions (bf16 on the card)")
    t0 = time.perf_counter()
    syn_terms, syn_vals = zipf_corpus_csr(rng, POSTINGS_DOCS)
    pool_q = check_pool(torch, model, tok, rng, 32, 64)
    pool_d = check_pool(torch, model, tok, rng, 32, 256)
    # the forward at the training shapes too, on the masks the V33 trainer's
    # collator builds from phase 4's kind of triplets, from a random stream
    # of its own (the later phases' data stay)
    pool_rng = np.random.default_rng([args.seed, 6])
    v33_batch = v33_pool_batches(tok, pool_rng)
    pool_train = [check_pool(torch, model, tok, pool_rng, B, S, v2=False,
                             enc=v33_batch[(B, S)])
                  for B, S in TRAIN_POOL_SHAPES]
    torch.cuda.empty_cache()
    probe = SparseEncoderV33(model, tok, query_top_k=64, device="cuda")
    resc = check_rescore(torch, probe, rng, syn_terms, syn_vals)
    # the backward kernels at the training shapes: docs (64 positives + 64
    # negatives) and unpacked queries
    bwd_d, bwd_q = (check_pool_backward(torch, model, tok, rng, B, S)
                    for B, S in TRAIN_POOL_SHAPES)
    # and at a length that is not a multiple of the bitmask's 32-position
    # words, from a random stream of its own (the later phases' data stay)
    bwd_r = check_pool_backward(torch, model, tok,
                                np.random.default_rng([args.seed, 5]),
                                *BWD_RAGGED)
    torch.cuda.empty_cache()
    # the attention kernels at the training micro-batches (packed query rows
    # at 256 positions, as the V33 step has them) and at a ragged length;
    # their inputs come from a stream of their own, so the phases after this
    # one draw the corpus, queries and triplets they always drew
    splash_rng = np.random.default_rng([args.seed, 4])
    splash = {(B, S, hw): check_splash(torch, splash_rng, B, S, hw,
                                       packed=S == 256)
              for B, S in SPLASH_SHAPES for hw in SPLASH_WINDOWS}
    splash_ragged = [check_splash(torch, splash_rng, *SPLASH_RAGGED, hw,
                                  packed=False, timed=False)
                     for hw in SPLASH_WINDOWS]
    torch.cuda.empty_cache()
    log(f"[2] done in {time.perf_counter() - t0:.1f} s")

    # ---- 3. the serving path
    log("[3] serving path")
    queries = hangul_texts(rng, 32, 6)
    pool_docs = hangul_texts(rng, 256, 60)
    dense_docs = hangul_texts(rng, 10_000, 80)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_splade_pool.launches = 0
    rescore_match.launches = 0
    tok.fill.clear()
    t0 = time.perf_counter()
    index = PostingsIndex(V, n_postings=256, query_top_t=64,
                          rescore_candidates=1000, device="cuda")
    index.add_csr([f"syn{i}" for i in range(len(syn_terms))], syn_terms,
                  syn_vals)
    doc_enc = SparseEncoderV33(model, tok, doc_top_k=64, device="cuda")
    index.add_batch([f"text{i}" for i in range(len(pool_docs))],
                    doc_enc.encode_documents(pool_docs))
    index.build()
    postings = ServingEngine(model, tok, index, query_top_k=64,
                             device="cuda")
    log(f"  postings engine: {len(index)} docs, scoring "
        f"{index.resolved_scoring()}, {index.memory_bytes() / 1e6:.0f} MB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense = build_engine_from_docs(
        model, tok, [(f"dense{i}", t) for i, t in enumerate(dense_docs)],
        int8=True, doc_top_k=256, index_type="dense", query_top_k=64,
        device="cuda")
    log(f"  dense engine: {dense.num_docs} docs int8, built in "
        f"{time.perf_counter() - t0:.1f} s")
    # the valid share of the batches the pool forward was given, by
    # max_length: the documents indexed, then what the requests sent
    fill = {"indexed": tok.valid_share()}
    tok.fill.clear()
    t0 = time.perf_counter()
    pool_at_indexed = fused_splade_pool.launches
    serving = {
        "postings": drive("postings", postings, model, queries, pool_docs[3]),
        "dense": drive("dense", dense, model, queries, dense_docs[5])}
    torch.cuda.synchronize()
    fill["served"] = tok.valid_share()
    log("  valid positions in the pool forward's batches, by padded "
        "length: " + "; ".join(
            f"{what} " + ", ".join(f"{share:.1%} of {n}"
                                   for n, share in sorted(got.items()))
            for what, got in fill.items()))
    launches = {"fused_splade_pool": fused_splade_pool.launches,
                "rescore_match": rescore_match.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[3] requests done in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches on the path {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"kernel {name} was not launched on the path")
    if launches["fused_splade_pool"] <= pool_at_indexed:
        raise SystemExit("the pool kernel encoded no served query")
    doc_encode_diff = compare_doc_encode(torch, doc_enc, model, pool_docs)
    profiles = {f"{name} B={b}": profile_batch(torch, name, engine,
                                                queries[:b])
                for name, engine in (("postings", postings), ("dense", dense))
                for b in (8, 32)}
    del postings, dense, index, doc_enc, probe, model
    torch.cuda.empty_cache()

    # ---- 4. training at full width
    log("[4] training path: the canonical V33 recipe at 22L/768/50K")
    t0 = time.perf_counter()
    training = train_phase(
        torch, tok, rng, Path(__file__).resolve().parent / "build"
        / "chip_smoke_train", args.seed, v33_recipe(),
        ModernBertConfig(remat=True))
    train_launches = training["launches"]
    log(f"[4] done in {time.perf_counter() - t0:.1f} s")
    accum = v33_recipe()["training"]["gradient_accumulation_steps"]
    hold_launches("V33 training path", train_launches, expected_launches(
        ModernBertConfig(remat=True), accum, training["measured_steps"], 2))
    torch.cuda.empty_cache()

    # ---- 5. MLM pre-training at full width, and the row-blocked pool's path
    log("[5] pre-training path: the MLM recipe at 22L/768/50K, preemption, "
        "from_checkpoint, the row-blocked pool under autograd")
    t0 = time.perf_counter()
    pretraining = mlm_phase(
        torch, tok, rng, Path(__file__).resolve().parent / "build"
        / "chip_smoke_mlm", args.seed, mlm_recipe(), ModernBertConfig())
    v2_launches = pretraining["v2_path"]["launches"]
    log(f"[5] done in {time.perf_counter() - t0:.1f} s; row-blocked kernel "
        f"launches on the path {v2_launches}")
    # the path's launches are at shapes, and at a row_block, that phase 2
    # held against the plain versions
    from splade_tpu_torch.ops.fused_splade_v2 import pick_row_block
    hold_launches("MLM pre-training path", pretraining["launches"],
                  expected_launches(ModernBertConfig(),
                                    mlm_recipe()["grad_accum"],
                                    pretraining["steps_run"], 0))
    for B, S in pretraining["v2_path"]["shapes"]:
        if ((B, S) not in TRAIN_POOL_SHAPES
                or pick_row_block(B) not in V2_ROW_BLOCKS):
            raise SystemExit(f"the row-blocked pool's path ran at B={B} "
                             f"S={S}, which phase 2 did not hold")
    for name, n in v2_launches.items():
        if n != len(pretraining["v2_path"]["shapes"]):
            raise SystemExit(f"kernel {name}: {n} launches on the "
                             "row-blocked pool's path, expected one a batch")

    torch.cuda.empty_cache()

    # ---- 6. both training paths through the attention kernels
    log("[6] attention_impl=\"splash\": the V33 recipe and the MLM recipe at "
        "22L/768/50K through the splash attention kernels")
    t0 = time.perf_counter()
    splash_v33_config = ModernBertConfig(remat=True, attention_impl="splash")
    splash_training = train_phase(
        torch, tok, rng, Path(__file__).resolve().parent / "build"
        / "chip_smoke_train_splash", args.seed, v33_recipe(),
        splash_v33_config)
    hold_launches("V33 training path, splash", splash_training["launches"],
                  expected_launches(splash_v33_config, accum,
                                    splash_training["measured_steps"], 2))
    torch.cuda.empty_cache()
    splash_mlm_config = ModernBertConfig(attention_impl="splash")
    splash_pretraining = mlm_phase(
        torch, tok, rng, Path(__file__).resolve().parent / "build"
        / "chip_smoke_mlm_splash", args.seed, mlm_recipe(), splash_mlm_config,
        checkpoint_config=splash_mlm_config)
    hold_launches("MLM pre-training path, splash",
                  splash_pretraining["launches"],
                  expected_launches(splash_mlm_config,
                                    mlm_recipe()["grad_accum"],
                                    splash_pretraining["steps_run"], 0))
    for name, sdpa, spl in (("V33", training, splash_training),
                            ("MLM", pretraining, splash_pretraining)):
        rate = "triplets_per_s" if name == "V33" else "tokens_per_s"
        line = (f"  {name} splash vs sdpa: {spl[rate]:.1f} vs "
                f"{sdpa[rate]:.1f} {rate.replace('_per_s', '/s')}, "
                f"{spl['step_ms']:.0f} vs {sdpa['step_ms']:.0f} ms a step, "
                f"peak {spl['peak_device_gb']:.2f} vs "
                f"{sdpa['peak_device_gb']:.2f} GB")
        if spl["profile"] and spl["profile"]["device_busy_ms"] is not None:
            top = lambda run: ", ".join(
                f"{k[:52]} {v:.1f}" for k, v in
                list(run["profile"]["top_kernels_ms"].items())[:4])
            pool = lambda run: sum(run["profile"]["port_kernels_ms"].get(k, 0.0)
                                   for k in POOL_BACKWARD)
            if name == "V33":
                line += (f"; pool backward (match pass + gathers) "
                         f"{pool(spl):.1f} vs {pool(sdpa):.1f} ms a profiled "
                         f"step ({pool(spl) / spl['profile']['device_busy_ms']:.1%}"
                         f" vs {pool(sdpa) / sdpa['profile']['device_busy_ms']:.1%}"
                         f" of busy)")
            line += (f"; profiled step busy "
                     f"{spl['profile']['device_busy_ms']:.1f} vs "
                     f"{sdpa['profile']['device_busy_ms']:.1f} ms, idle "
                     f"{spl['profile']['device_idle_share']:.1%} vs "
                     f"{sdpa['profile']['device_idle_share']:.1%}; top "
                     f"device items, ms a step, splash: {top(spl)}; sdpa: "
                     f"{top(sdpa)}")
        log(line)
    log(f"[6] done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ---- 7. data-parallel training over torch.distributed
    log("[7] data parallel: the V33 CLI at world 1 over NCCL, V33 and MLM "
        f"at world {DP_WORLD} on this card over gloo (splash route), the "
        "MLM CLI at world 1 over NCCL; 22L/768/50K")
    t0 = time.perf_counter()
    dp_root = Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
    dp_v33 = v33_cli_phase(torch, np.random.default_rng([args.seed, 7]),
                           dp_root / "v33_cli", v33_recipe(),
                           ModernBertConfig(remat=True))
    world1 = dp_v33["world1"]
    log(f"  V33 world 1 over NCCL: {world1['per_s']:.1f} triplets/s over "
        f"the steps after the first (phase 4, no process group: "
        f"{training['triplets_per_s']:.1f}, {training['step_ms']:.0f} ms a "
        f"step); gradient all-reduce {dp_v33['allreduce_ms']} ms a step")
    dp_world2 = data_parallel_phase(
        torch, tok, np.random.default_rng([args.seed, 8]),
        dp_root / "world2", args.seed, v33_recipe(), splash_v33_config,
        mlm_recipe(), splash_mlm_config)
    dp_mlm = mlm_cli_phase(torch, np.random.default_rng([args.seed, 9]),
                           dp_root / "mlm_cli", mlm_recipe())
    log(f"[7] done in {time.perf_counter() - t0:.1f} s")
    dp_launches = {
        "data parallel, V33 CLI world 1": world1["launches"],
        **{f"data parallel, V33 world {DP_WORLD} rank {r}": x
           for r, x in enumerate(dp_world2["v33"]["launches"])},
        **{f"data parallel, MLM world {DP_WORLD} rank {r}": x
           for r, x in enumerate(dp_world2["mlm"]["launches"])}}
    splash_launches = {
        name: {"V33 training, splash": splash_training["launches"][name],
               "MLM pre-training, splash":
                   splash_pretraining["launches"][name]}
        for name in ("splash_attention", "splash_attention_bwd_dq",
                     "splash_attention_bwd_dkv")}

    kernels = [
        dict(name="fused_splade_pool", route="cuda",
             source="splade_tpu_torch/csrc/fused_splade_fwd.cu",
             replaces="splade_tpu/ops/fused_splade.py:50",
             launches=launches["fused_splade_pool"],
             launches_by_path={
                 "serving": launches["fused_splade_pool"],
                 "training": train_launches["fused_splade_pool"],
                 **{path: got["fused_splade_pool"]
                    for path, got in dp_launches.items()}},
             **{k: pool_d[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
             max_abs_err_all=max(x["max_abs_err"]
                                 for x in (pool_d, pool_q, *pool_train)),
             shapes=[{k: v for k, v in x.items() if k != "v2"}
                     for x in (pool_d, pool_q, *pool_train)],
             ptxas=ptxas["fused_splade_fwd_kernel"]),
        dict(name="rescore_match", route="cuda",
             source="splade_tpu_torch/csrc/rescore.cu",
             replaces="splade_tpu/ops/rescore_kernel.py:54",
             also_replaces="splade_tpu/ops/rescore_kernel.py:127",
             launches=launches["rescore_match"],
             **{k: resc[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
             shapes=[resc], ptxas=ptxas["rescore_kernel"]),
    ]
    # the per-row backward: the match pass (the recompute of both Pallas
    # kernels), then each gradient's gather; a gradient's "ms" is its match
    # pass and gather together, the function its bound and library time are
    # of ("gather_ms" and "match_ms" beside it)
    for name, which, line, also in (
            ("fused_splade_bwd_match", "match", 93, 111),
            ("fused_splade_bwd_dh", "dh", 93, None),
            ("fused_splade_bwd_dw", "dw", 111, None)):
        shapes = [x["v1"][which] for x in (bwd_d, bwd_q, bwd_r)]
        kernels.append(dict(
            name=name, route="cuda",
            source="splade_tpu_torch/csrc/fused_splade_bwd.cu",
            replaces=f"splade_tpu/ops/fused_splade.py:{line}",
            **({"also_replaces": f"splade_tpu/ops/fused_splade.py:{also}"}
               if also else {}),
            launches=train_launches[name],
            launches_by_path={"training": train_launches[name],
                              **{path: got[name]
                                 for path, got in dp_launches.items()}},
            **{k: shapes[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            max_abs_err_all=max(x["max_abs_err"] for x in shapes),
            shapes=shapes))
    # the row-blocked family: the headline numbers are row_block 8 at the
    # document shape; every shape and row_block stands under "shapes", the
    # per-row kernels' time on the same inputs beside each ("v1_ms"). Its
    # backward is its own match pass and the per-row family's gathers: a
    # gradient's "ms" is the match pass and its gather together, as above
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rb0 = V2_ROW_BLOCKS[0]
    v2_bwd = "splade_tpu_torch/csrc/fused_splade_v2_bwd.cu"
    for name, source, line, also, shapes in (
            ("fused_splade_pool_v2",
             "splade_tpu_torch/csrc/fused_splade_fwd.cu", 46, None,
             [x["v2"][rb] for x in (pool_d, pool_q) for rb in V2_ROW_BLOCKS]),
            ("fused_splade_bwd_match_v2", v2_bwd, 65, 87,
             [x[f"v2 rb={rb}"]["match"] for x in (bwd_d, bwd_q, bwd_r)
              for rb in V2_ROW_BLOCKS]),
            ("fused_splade_bwd_dh_v2", v2_bwd, 65, None,
             [x[f"v2 rb={rb}"]["dh"] for x in (bwd_d, bwd_q, bwd_r)
              for rb in V2_ROW_BLOCKS]),
            ("fused_splade_bwd_dw_v2", v2_bwd, 87, None,
             [x[f"v2 rb={rb}"]["dw"] for x in (bwd_d, bwd_q, bwd_r)
              for rb in V2_ROW_BLOCKS])):
        assert shapes[0]["row_block"] == rb0
        kernels.append(dict(
            name=name, route="cuda", source=source,
            **({"gather_source": "splade_tpu_torch/csrc/fused_splade_bwd.cu"}
               if name.endswith(("dh_v2", "dw_v2")) else {}),
            replaces=f"splade_tpu/ops/fused_splade_v2.py:{line}",
            **({"also_replaces": f"splade_tpu/ops/fused_splade_v2.py:{also}"}
               if also else {}),
            launches=v2_launches[name],
            launches_by_path={"row-blocked pool under autograd":
                              v2_launches[name]},
            **{k: shapes[0][k] for k in keys},
            max_abs_err_all=max(x["max_abs_err"] for x in shapes),
            shapes=shapes))
    # the attention kernels: the headline numbers are the V33 micro-batch on
    # a local layer (14 of the 22); every shape and window under "shapes"
    head = (*SPLASH_SHAPES[0], SPLASH_WINDOWS[0])
    for name, which, source in (
            ("splash_attention", "fwd", "splash_attention_fwd.cu"),
            ("splash_attention_bwd_dq", "dq", "splash_attention_bwd.cu"),
            ("splash_attention_bwd_dkv", "dkv", "splash_attention_bwd.cu")):
        shapes = ([splash[head][which]]
                  + [x[which] for key, x in splash.items() if key != head]
                  + [x[which] for x in splash_ragged])
        kernels.append(dict(
            name=name, route="cuda",
            source=f"splade_tpu_torch/csrc/{source}",
            replaces="splade_tpu/models/modernbert.py:140",
            launches=sum(splash_launches[name].values()),
            launches_by_path={**splash_launches[name],
                              **{path: got[name]
                                 for path, got in dp_launches.items()}},
            **{k: shapes[0][k] for k in keys},
            max_abs_err_all=max(x["max_abs_err"] for x in shapes),
            shapes=shapes,
            **({"ptxas": ptxas["splash_fwd_kernel"]} if which == "fwd"
               else {})))
    for entry in kernels:
        if entry["launches"] <= 0:
            raise SystemExit(f"kernel {entry['name']} was launched no time on "
                             "its path")
    log(json.dumps({"serving": serving, "batch_profiles": profiles,
                    "pool_valid_share": fill,
                    "doc_encode_max_rel_diff": doc_encode_diff,
                    "peak_device_gb": peak_gb}))
    log(json.dumps({"training": training}))
    log(json.dumps({"pretraining": pretraining}))
    log(json.dumps({"splash": {"training": splash_training,
                               "pretraining": splash_pretraining},
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"data_parallel": {
        "v33_cli_world1": dp_v33, "world2_gloo": dp_world2,
        "mlm_cli_world1": dp_mlm,
        "phase4_triplets_per_s": training["triplets_per_s"],
        "phase4_step_ms": training["step_ms"]}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--cli"]:
        sys.exit(cli_entry(sys.argv[2:]))
    sys.exit(main())
