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
8. The benchmark path: the port's benchmark CLI (``python -m
   splade_tpu_torch.benchmark.runner``, through ``--cli bench``: the
   stand-in tokenizers in place of the HF ones) in processes of its own,
   on 2,000 synthetic Hangul triplets with 3 negatives each (``--dataset
   triplet-val --sample-size 500``: 500 queries over 2,000 documents). The
   sparse model is the seeded 22L/768/50K SpladeEncoder in bf16 through the
   pool kernel, its decoder bias set so that vectors are as sparse as a
   trained model's, read through ``--checkpoint`` from a model.pt dir; the
   dense model is XLM-R at BGE-M3's published shape (24 layers, 1024
   hidden, 16 heads, 250,002 vocab) with seeded random weights, read as an
   HF dir through ``--dense-checkpoint`` at 512 tokens. (a) ``--index
   exact --postings-index --cluster-index`` with the dense model and
   ``--encodings``: 13 methods. (b) ``--index gpu --no-hybrid`` on (a)'s encodings. (c)
   ``precompute_teacher_scores`` over the 2,000 triplets with the teacher,
   a second call that must reuse its cache, ``mine_multi_negatives`` with
   3 negatives. Held: every method present and no query failed; each
   query's top 10 from the postings row (PostingsIndex + the rescore
   kernel) and from (b)'s ImpactIndex against the exact CSR search on the
   same vectors, equal where scores are apart by more than the index's
   rounding (bf16 or int8 weights), and the cluster row's (ClusterIndex:
   the cluster and postings union, the same rescore; an approximate index)
   so against the exact search over the candidates each query's search
   rescored (the union, recorded on an index rebuilt from the encodings
   with the runner's configuration, whose probed clusters are held against
   a plain numpy reading of the summaries, ``cluster_probe_check``), its
   recall@10 against the search over every document printed; the two
   kernels against their plain
   versions at the shapes this path gives them, in this process: 64 corpus
   documents' vectors (B=32, S=256) and 64 queries' (B=1, S=64, as the
   runner encodes a query), kernel route against the plain one, and the
   rescore kernel against ``rescore_match_plain`` at every rescore the
   postings row makes for each of the run's query vectors (the run's
   PostingsIndex rebuilt from its encodings with the runner's own serving
   configuration: the same doc-major block and candidates); the teacher's embeddings of 32 texts: unit
   norm, its module in f32 against a plain f32 XLM-R forward written here,
   bf16 against f32 within twice a floor measured first on other weights;
   the launches the code implies (the pool forward once a document batch
   and once a distinct query a run, the rescore once a query of each of the
   postings and cluster rows); the mined rows well formed. Printed beside the card's name and power limit:
   sparse and dense documents/s, each method's latency p50 / p99, the
   teacher's texts/s in (c), the phase's seconds. Recall with random
   weights measures nothing and is printed only as a count.
9. Train -> HF export -> serve, through the two indexes of one card that
   phase 3 does not serve. (a) Phase 5's saved pre-trained model
   (22L/768/50K, ``final_model/model.pt``) through the export CLI
   (``python -m splade_tpu_torch.export``, run as ``python chip_smoke.py
   --cli export ...`` with the stand-in tokenizer) in a process of its own;
   the dir holds config.json and model.safetensors, whose header the port's
   reader parses; ``load_hf_checkpoint`` gives every saved tensor bitwise
   and no other; 64 documents (B=32, S=256) encoded by the exported model
   are bitwise the saved model's vectors and within SERVE_RTOL of the plain
   route. (b) A ``TieredPostingsIndex`` (cold P=256, 2,048 hot terms of
   8,192 more postings, T=64, C=1,000) over phase 3's 1,000,000 synthetic
   documents plus 256 the exported model encodes (its 64 strongest terms
   each), served behind the HTTP server as phase 3 serves (``drive``:
   batched /search at k=10 and 100 held against the same index's plain
   path, single-query latency, /encode, /index then /search through the
   delta); launches held at one pool forward and one rescore a batch; one
   warmed B=32 batch under ``utils/profiling.py::profile_fn`` (wall, busy,
   idle share, top kernels). (c) A ``ClusterIndex`` (G=64, L=32 probes,
   a 64-posting side of 128 candidates, T=64) over the same documents, its
   host build time and summary bytes printed, served and held as (b); no
   served list holds a document twice; at a B=32 search the rescore kernel
   against ``rescore_match_plain`` on the union it is given (C = L*G + 128
   = 2,176 candidates with duplicates and the pad row, doc id n): within
   CLUSTER_RESCORE_TOL of max(1, top score), pad candidates scoring 0 and
   each duplicate's copies bitwise equal, and its time in a CUDA graph
   beside the byte bound (each distinct row read once); the clusters that
   union probed against a plain numpy reading of the summaries
   (``cluster_probe_check``: ties within PROBE_RTOL allowed); recall@10 of
   both indexes against the exact search is printed, not held. (d) The server CLI (``python -m
   splade_tpu_torch.serving.server --checkpoint <export dir>``, run as
   ``python chip_smoke.py --cli serve ...``, which keeps SERVE_DOC_TOP_K
   terms a document) over 2,000 synthetic documents with ``--index tiered --rescore 1000`` and with ``--index cluster
   --posting-scoring sort``, each writing its ``--index-cache``; both
   restarted from their caches alone. Held: each cache records the kind
   asked for, each restart logs loading that kind and returns the cold
   run's results (SERVE_RTOL). The launch counts of (b) and (c) are read
   around each path alone.

10. The mesh-sharded indexes on one card: ``make_mesh(devices=["cuda:0"]
   * 8)``, eight shards every one on the card, at phase 3's and phase 9's
   configurations, the seeded 22L/768/50K model of phase 3 and the
   stand-in tokenizer. (a) A two-phase ``MeshShardedPostingsIndex`` (P=256,
   C=1,000, T=64) over phase 3's 1,000,000 synthetic documents plus its 256
   text documents (125,032 a shard); (b) a
   ``MeshShardedTieredPostingsIndex`` (cold P=256, 2,048 hot terms x 8,192,
   T=64, C=1,000) and (c) a ``MeshShardedClusterIndex`` (G=64, L=32, a
   64-posting side of 128 candidates, T=64) over the same documents; (d)
   ``build_engine_from_docs(mesh=...)``'s int8 row-sharded ``ImpactIndex``
   over phase 3's 10,000 dense documents. Each served behind the HTTP
   server as phase 9 serves (``drive``) and held: against the same index's
   plain path (SERVE_RTOL); (d) against a single-device ``ImpactIndex`` over
   the same vectors (up to tie order); on (a)-(c) the raw merged top-k of
   one batched search, every positive score the exact dot product of its
   query and document's stored weights (MESH_EXACT_RTOL), no id twice or
   past n, and for (c) no pad document at the whole candidate pool; the
   rescore kernel on each shard's own candidates against its plain version
   (for (c) with pads and duplicates); every shard searched with its own
   card current (``torch.cuda.device``); the launches read around each
   path alone, one pool forward and 8 rescores a batch ((d): none). Printed
   for each: host build seconds, device bytes, peak device GB, one warmed
   B=32 batch under ``profile_fn``, recall@10 against the exact search.

11. The offline data tier feeding V33 training (``data_phase``; alone:
   ``python -c "import chip_smoke; chip_smoke.data_main()"``). (a) 10,000
   raw samples written as local JSONL drops under ``$SPLADE_RAW_DATA``
   (QA, dialog, direct triplets, NLI, STS and classification registry
   keys), Hangul from the port's ``random_hangul_stems``, with 5% exact and
   5% near duplicates and 2% English-only rows planted: cut from the
   reference's 4.84M triplets out of nine datasets. (b)
   ``PreprocessingPipeline(config, miner=TfidfHardNegativeMiner(top_k=1))
   .run()`` (collect, convert, clean, dedup, mine, shard; each stage's
   seconds): every written row parses through ``load_training_data`` and
   collates through ``TripletCollator``, no negative equals its positive,
   no (query, positive) twice. (c) ``EncoderHardNegativeMiner`` on the card
   with an encoder of a few lines (``MiningAdapter``:
   ``SparseEncoderV33.encode_tensor``, the pool forward kernel, [N, 50,000]
   f32): ``mine_rank_window`` (ranks [10, 50), k 7 of the top 100) and
   ``mine_band`` over 1,024 of the pipeline's queries against 8,192
   positives (1.64 GB on the device), first with the decoder bias shifted
   by ``sparsify`` (sparse vectors), then as the weights are (dense
   vectors, crowded cosines); on 64 sampled queries every mined similarity
   equals a float64 host recomputation's at the same rank within
   DATA_SIM_TOL (sparse) or twice the product's measured f32 error
   (dense), no id is the positive, band ids lie in the band, min(in band,
   k) of them; the pool forward held against its plain version at
   mining's B = 256, S = 128 and launched once an encode batch. (d) ``compute_idf`` of the train
   shards' texts in both modes, bitwise an independent count (numpy
   ``unique`` per document) and through ``<prefix>.bin`` / ``.json`` and
   ``load_idf``. (e) PMI over the pipeline's positives and the synonym
   validator over term pairs read from a local ``$SPLADE_TERM_DATA`` cache
   by the port's collectors (planted pairs valid, apart pairs not, OOV
   rejected; the pair counts against a direct scan); the information-gain
   filter at n = 5,000, d = 768 in f64 on the card against the CPU (1e-9)
   on planted pairs (``ig_pairs``): the trivial half dropped. (f) The V33
   CLI (phase 7 (a)'s recipe, 22L/768/50K) as one process for 3 steps on
   the pipeline's train shards: the loader read every train row, finite
   losses, the launches the code implies.

The last ten lines are the training JSON, the pre-training JSON, the
splash training JSON, the data-parallel JSON, the benchmark JSON, the
serving JSON of phase 9, the mesh JSON of phase 10, the data tier's JSON
of phase 11, the kernels' JSON and the run's JSON.
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
from unittest import mock

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
    ``pack_corpus`` asks of a tokenizer (one flat list for one string, as the
    benchmark's BM25 word-piece analyzer asks). ``fill`` counts the valid and the
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
                 max_length=64, return_tensors="np", add_special_tokens=True,
                 verbose=True):
        one = isinstance(texts, str)
        all_codes = [[4 + ord(c) % (V - 4) for c in t if not c.isspace()]
                     for t in ([texts] if one else texts)]
        if not add_special_tokens:
            return {"input_ids": all_codes[0] if one else all_codes}
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

    def save_pretrained(self, path) -> None:
        """What an HF tokenizer writes beside a model: here a note naming
        the stand-in (it is defined by this file, not by files)."""
        (Path(path) / "tokenizer_config.json").write_text(json.dumps(
            {"tokenizer_class": "CharTokenizer (chip_smoke.py stand-in)",
             "vocab_size": V, "pad_token_id": self.pad_token_id}))

    def valid_share(self) -> dict:
        """max_length -> the share of valid positions in the padded batches
        made since ``fill`` was last cleared."""
        with self._lock:
            return {n: v / max(p, 1) for n, (v, p) in self.fill.items()}


class DenseCharTokenizer:
    """Character-level stand-in for BGE-M3's XLM-R tokenizer (which is not
    in the repository), shaped as XLM-R's: ``<s>`` = 0 first, ``</s>`` = 2
    last, one id in [4, vocab) per non-space character, padded with the
    model config's pad id (1 for XLM-R: ``roberta_position_ids`` counts the
    ids that are not the pad id, so padding of another id would be numbered
    as tokens)."""

    bos_token_id, eos_token_id = 0, 2

    def __init__(self, vocab_size: int, pad_token_id: int = 1):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id

    @classmethod
    def from_dir(cls, model_dir) -> "DenseCharTokenizer":
        """The stand-in for the model of an HF dir, from its config.json."""
        cfg = json.loads((Path(model_dir) / "config.json").read_text())
        return cls(cfg["vocab_size"], cfg.get("pad_token_id", 1))

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=512, return_tensors="np"):
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [4 + ord(c) % (self.vocab_size - 4) for c in t
                     if not c.isspace()][:max_length - 2]
            codes = [self.bos_token_id] + codes + [self.eos_token_id]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


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
    timed, kernel = time_rescore(torch, *args, plain_iters=5)
    launched_ms = cuda_ms(torch, kernel, iters=200, warmup=5)
    gather_ms = cuda_ms(torch, lambda: exact_rescore(
        d_terms, d_vals, d_scale, sparse_query_dense(q_idx, q_val, V), cand),
        iters=20, warmup=2)
    log(f"  rescore: kernel {timed['ms']:.5f} ms in a CUDA graph, "
        f"{launched_ms:.5f} ms a launch from Python (the scanning kernel it "
        f"replaced {SCAN_RESCORE_MS} ms in PERF.md, timed launch by "
        f"launch), plain match {timed['plain_ms']:.4f} ms, plain gather "
        f"(exact_rescore) {gather_ms:.4f} ms, {rescore_bound_text(timed)}")
    return dict(timed, shape=f"B={B} C={C} M={M} T={T} N={N}",
                max_abs_err=err, launched_ms=launched_ms,
                gather_ms=gather_ms)


def rescore_bound(torch, d_vals, q_idx, cand) -> tuple:
    """(bound ms, what bounds it, bytes, operations, distinct rows) of one
    rescore of the candidates ``cand`` [B, C] of the doc-major block: each
    distinct document row the candidates name read once (M int32 terms, M
    int8 values and an f32 scale), each int32 candidate id read and each
    f32 score written once, the queries (T int32 ids and T f32 weights a
    row) read once; one table lookup and one multiply-add a nonzero slot
    of each distinct (query, candidate) pair, at the f32 peak. A
    duplicated candidate, or the pad row of a cluster union, counts
    once."""
    B, C = cand.shape
    N, M = d_vals.shape
    T = q_idx.shape[1]
    rows = torch.unique(cand).numel()
    moved = rows * (5 * M + 4) + B * C * 8 + B * T * 8
    pairs = torch.unique(cand.long() + N * torch.arange(
        B, device=cand.device)[:, None])
    ops = 2.0 * int((d_vals[pairs % N] != 0).sum())
    return (*bound(moved, ops, H100_FP32_OPS), moved, ops, rows)


def rescore_bound_text(timed: dict) -> str:
    return (f"bound {timed['bound_ms']:.5f} ms ({timed['bound_by']}: "
            f"{timed['moved_bytes'] / 1e6:.2f} MB over "
            f"{timed['distinct_rows']} distinct rows, {timed['ops']:.3e} "
            f"lookups and multiply-adds; {timed['bound_ms'] / timed['ms']:.1%}"
            " of it)")


def time_rescore(torch, d_terms, d_vals, d_scale, q_idx, q_val, cand,
                 plain_iters: int) -> tuple:
    """On the card: the rescore kernel's C entry on these inputs, timed in
    a CUDA graph (``graph_ms``), ``rescore_match_plain``'s time on them and
    the bound (``rescore_bound``). Neither goes through the counted
    wrapper. -> (those numbers, the launch as a closure)."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.rescore_kernel import rescore_match_plain

    B, C = cand.shape
    N, M = d_terms.shape
    T = q_idx.shape[1]
    lib = _cuda.library()
    qi = q_idx.to(torch.int32).contiguous()
    qv = q_val.to(torch.float32).contiguous()
    ci = cand.to(torch.int32).contiguous()
    res = torch.empty((B, C), dtype=torch.float32, device=cand.device)

    def kernel():
        _cuda.check(lib.splade_rescore_match(
            d_terms.data_ptr(), d_vals.data_ptr(), d_scale.data_ptr(),
            qi.data_ptr(), qv.data_ptr(), ci.data_ptr(), res.data_ptr(),
            N, B, C, M, T, torch.cuda.current_stream().cuda_stream),
            "splade_rescore_match")

    ms = graph_ms(torch, kernel, iters=200)
    plain_ms = cuda_ms(torch, lambda: rescore_match_plain(
        d_terms, d_vals, d_scale, q_idx, q_val, cand), iters=plain_iters,
        warmup=1)
    bound_ms, bound_by, moved, ops, rows = rescore_bound(torch, d_vals,
                                                         q_idx, cand)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, moved_bytes=moved, ops=ops,
                distinct_rows=rows, library_ms=None), kernel


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
    from torch.profiler import ProfilerActivity, profile

    from splade_tpu_torch.utils.profiling import device_spans, summarize_spans

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
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


def compare_doc_encode(torch, enc, model, texts, max_length=None,
                       batch_size=None, what: str = "document") -> float:
    """The document vectors the postings engine indexed (pool_impl
    'kernel', S = doc_max_length, the encoder's batch) against the plain
    path's on the same texts, as dense [B, V] rows: within SERVE_RTOL of
    each row's largest weight. ``max_length`` and ``batch_size`` give
    another shape (a query, encoded alone). Returns the largest relative
    difference."""
    worst = 0.0
    S = max_length or enc.doc_max_length
    B = batch_size or enc.batch_size
    for i in range(0, len(texts), B):
        batch = enc.tokenize(texts[i:i + B], S)
        got = enc.encode_tensor(*batch)
        model.pool_impl = "streamed"
        try:
            want = enc.encode_tensor(*batch)
        finally:
            model.pool_impl = "kernel"
        scale = want.abs().amax(1, keepdim=True).clamp_min(1e-6)
        worst = max(worst, float(((got - want).abs() / scale).max()))
    log(f"  {what} encode B={B} S={S}, {len(texts)} texts: "
        f"kernel == plain path (max relative diff {worst:.2e}, "
        f"tol {SERVE_RTOL})")
    if not worst <= SERVE_RTOL:
        raise SystemExit(f"{what} vectors differ from the plain path")
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
    kernels a training or serving path can launch: the per-row pool family,
    the splash attention and the exact rescore."""
    from splade_tpu_torch.ops import (fused_splade, rescore_kernel,
                                      splash_attention)

    return {"fused_splade_pool": fused_splade.fused_splade_pool,
            "fused_splade_bwd_match": fused_splade.fused_splade_bwd_match,
            "fused_splade_bwd_dh": fused_splade.fused_splade_bwd_dh,
            "fused_splade_bwd_dw": fused_splade.fused_splade_bwd_dw,
            "splash_attention": splash_attention.splash_attention,
            "splash_attention_bwd_dq":
                splash_attention.splash_attention_bwd_dq,
            "splash_attention_bwd_dkv":
                splash_attention.splash_attention_bwd_dkv,
            "rescore_match": rescore_kernel.rescore_match}


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
    backward kernel once; with "sdpa" none; the rescore never."""
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
            "splash_attention_bwd_dkv": layers * micro,
            "rescore_match": 0}


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
              v2_shapes=TRAIN_POOL_SHAPES, checkpoint_config=None,
              keep_final=None) -> dict:
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
    tokenizer's vocabulary, as a user loads a full-size model).
    ``keep_final``: where the final model dir moves to before the work
    dir is removed (phase 9 exports it)."""
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
    if keep_final is not None:
        shutil.rmtree(keep_final, ignore_errors=True)
        Path(keep_final).parent.mkdir(parents=True, exist_ok=True)
        shutil.move(final, str(keep_final))
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


# ------------------------------------------------------------ phase 8
def bge_m3_shape() -> dict:
    """BGE-M3's published backbone (its config.json: XLM-RoBERTa large),
    the shape of phase 8's dense model: XlmRobertaConfig's defaults, in
    HF's names; named here, never downloaded."""
    from splade_tpu_torch.models.xlmr import XlmRobertaConfig

    shape = dataclasses.asdict(XlmRobertaConfig())
    del shape["dtype"]
    return shape


#: synthetic triplets written, negatives each, and the queries the runner
#: samples (--sample-size: 500 x (1 + 3) = 2,000 documents)
BENCH_TRIPLETS, BENCH_NEGATIVES, BENCH_QUERIES = 2000, 3, 500
#: words (two syllables each) of a document: past the 256-token cut
BENCH_DOC_WORDS = (140, 170)
BENCH_QUERY_WORDS = 6
BENCH_DENSE_LEN = 512
#: seeded random weights put nearly every vocab entry's maximum above 0 (a
#: document of 50K nonzeros); the decoder bias is set to -t, one t for
#: both, taken from a sample so that documents hold at least about
#: BENCH_DOC_NNZ nonzeros and queries at least about BENCH_QUERY_NNZ, as a
#: trained model's sparse vectors are. The smaller threshold wins: with the
#: seeded model it is the queries', so documents come out near 442
#: nonzeros, not 256
BENCH_DOC_NNZ, BENCH_QUERY_NNZ = 256, 24
#: queries whose vectors the query encode check holds (B=1, S=64)
BENCH_QUERY_CHECK = 64
#: the methods of run (a) (tests/test_dense_cli.py's 11 and the postings
#: row) and of run (b)
BENCH_METHODS = {
    "bm25", "neural_sparse", "semantic", "bm25_semantic_rrf", "hybrid_rrf",
    "hybrid_linear_0.3", "hybrid_linear_0.4", "hybrid_linear_0.5",
    "hybrid_weighted_rrf", "bm25_sparse_rrf", "triple_rrf",
    "neural_sparse_postings", "neural_sparse_cluster"}
BENCH_GPU_METHODS = {"bm25", "neural_sparse"}
#: the sparse rows whose per-query lists run (a) and (b) record
BENCH_SPARSE_ROWS = ("neural_sparse", "neural_sparse_postings",
                     "neural_sparse_cluster")
#: the postings index of --postings-index and the cluster index of
#: --cluster-index: the query's strongest terms each keeps
#: (splade_tpu_torch/benchmark/runner.py)
POSTINGS_QUERY_TOP_T = 32
#: the teacher's f32 module against the plain f32 forward below: the same
#: function in f32, so only the order of sums differs; relative to the
#: largest element of the normalized embedding
TEACHER_F32_RTOL = 1e-4
#: unit norm of each normalized bf16 embedding
TEACHER_NORM_ATOL = 1e-3
BENCH_TIMEOUT_S = 600.0
#: the sparse encoder's batch (SparseEncoderV33's default: the CLI sets none)
BENCH_ENCODE_BATCH = 32


def bench_triplets(rng, n: int, doc_words=BENCH_DOC_WORDS,
                   query_words: int = BENCH_QUERY_WORDS,
                   negatives: int = BENCH_NEGATIVES) -> list:
    """Hangul triplets whose positive holds the query's words among random
    ones (so BM25 has something to find), with ``negatives`` random
    documents each."""
    stems = ["".join(chr(0xAC00 + int(x)) for x in rng.integers(0, 11172, 2))
             for _ in range(400)]

    def doc(extra=()):
        words = [stems[j] for j in rng.integers(
            0, len(stems), int(rng.integers(*doc_words)))]
        for w in extra:
            words.insert(int(rng.integers(0, len(words) + 1)), w)
        return " ".join(words)

    rows = []
    for _ in range(n):
        query = [stems[j] for j in rng.integers(0, len(stems), query_words)]
        rows.append({"query": " ".join(query), "positive": doc(query),
                     "negatives": [doc() for _ in range(negatives)]})
    return rows


def sparse_bench_model(torch, tok, texts, queries, seed: int, device: str,
                       over=None, doc_nnz: int = BENCH_DOC_NNZ,
                       query_nnz: int = BENCH_QUERY_NNZ):
    """The seeded SpladeEncoder in bf16 made sparse by ``sparsify``. ->
    (model, t, the sample's mean nonzeros a document and a query after the
    shift)."""
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder

    cfg = ModernBertConfig(**{"vocab_size": V, "pad_token_id":
                              tok.pad_token_id, **(over or {})})
    model = SpladeEncoder(cfg, pool_impl="kernel", device=device)
    model = model.init_weights(seed).to(torch.bfloat16).eval()
    t, nnz = sparsify(torch, model, tok, texts, queries, device, doc_nnz,
                      query_nnz)
    return model, t, nnz


def sparsify(torch, model, tok, texts, queries, device: str,
             doc_nnz: int = BENCH_DOC_NNZ,
             query_nnz: int = BENCH_QUERY_NNZ) -> tuple:
    """Set the model's decoder bias to itself - t: t the largest threshold
    that leaves at least ``doc_nnz`` maxima a document and ``query_nnz`` a
    query above it, on average over the sample (a uniform bias moves every
    maximum m[b, v] of the pool by the same amount, so one t serves both:
    the smaller of the two thresholds, and the other kind of text gets more
    nonzeros than its target; a vector's values are log1p(m) where m > 0),
    so that vectors are as sparse as a trained model's. -> (t, the
    sample's mean nonzeros a document and a query after the shift)."""
    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33

    enc = SparseEncoderV33(model, tok, filter_special=False, device=device)

    def maxima(sample, max_length):
        out = []
        for i in range(0, len(sample), enc.batch_size):
            rows = enc.encode_tensor(*enc.tokenize(
                sample[i:i + enc.batch_size], max_length))
            out.append(torch.expm1(rows).cpu())
        return torch.cat(out)  # m where m > 0, else 0

    thresholds, sample = [], {}
    for name, sample_texts, max_length, want in (
            ("docs", texts, enc.doc_max_length, doc_nnz),
            ("queries", queries, enc.query_max_length, query_nnz)):
        m = maxima(sample_texts, max_length)
        sample[name] = m
        pos = m[m > 0].sort(descending=True).values
        thresholds.append(float(pos[min(want * len(m), len(pos)) - 1]))
    t = min(thresholds)
    with torch.no_grad():
        model.mlm.decoder.bias.sub_(t)
    nnz = {name: float((m > t).sum(1).float().mean())
           for name, m in sample.items()}
    return t, nnz


def xlmr_init(torch, config, seed: int, device: str):
    """An XlmRobertaEncoder with seeded random weights as HF initializes
    XLM-R (normal 0.02, unit LayerNorm scales, zero biases), drawn by a
    generator on the device."""
    from splade_tpu_torch.models.xlmr import XlmRobertaEncoder

    with torch.device(device):
        model = XlmRobertaEncoder(config).eval()
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape, dtype=torch.float32,
                                    device=device).normal_(0.0, 0.02,
                                                           generator=g))
    return model


def write_dense_checkpoint(torch, model, shape: dict, path: Path) -> None:
    """An HF-format XLM-R dir: config.json + pytorch_model.bin (bf16
    values, the checkpoint BGEM3Teacher.from_hf_dir reads in bf16)."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(
        {"model_type": "xlm-roberta", "architectures": ["XLMRobertaModel"],
         "hidden_act": "gelu", **shape}, indent=2))
    torch.save({k: v.to(torch.bfloat16).cpu()
                for k, v in model.state_dict().items()},
               path / "pytorch_model.bin")


def xlmr_plain_cls(torch, state: dict, shape: dict, ids, mask):
    """XLM-R's normalized CLS embedding in f32 from HF-named weights,
    written out here apart from the port's module: RoBERTa positions,
    post-LN layers, masked keys excluded from every softmax."""
    F = torch.nn.functional
    w = lambda k: state[k].float()
    H, n = shape["hidden_size"], shape["num_attention_heads"]
    eps, pad = shape["layer_norm_eps"], shape["pad_token_id"]
    B, S = ids.shape
    valid = ids.ne(pad).long()
    pos = torch.cumsum(valid, 1) * valid + pad
    x = (w("embeddings.word_embeddings.weight")[ids]
         + w("embeddings.position_embeddings.weight")[pos]
         + w("embeddings.token_type_embeddings.weight")[0])
    ln = lambda x, k: F.layer_norm(x, (H,), w(k + ".weight"), w(k + ".bias"),
                                   eps)
    x = ln(x, "embeddings.LayerNorm")
    keys = mask.bool()[:, None, None, :]
    for i in range(shape["num_hidden_layers"]):
        pre = f"encoder.layer.{i}."
        lin = lambda t, k: F.linear(t, w(pre + k + ".weight"),
                                    w(pre + k + ".bias"))
        q, k, v = (lin(x, f"attention.self.{r}").view(B, S, n, H // n)
                   .transpose(1, 2) for r in ("query", "key", "value"))
        s = (q @ k.transpose(-1, -2)) / (H // n) ** 0.5
        a = torch.softmax(s.masked_fill(~keys, float("-inf")), -1) @ v
        a = a.transpose(1, 2).reshape(B, S, H)
        x = ln(x + lin(a, "attention.output.dense"),
               pre + "attention.output.LayerNorm")
        x = ln(x + lin(F.gelu(lin(x, "intermediate.dense")), "output.dense"),
               pre + "output.LayerNorm")
    cls = x[:, 0]
    return cls / cls.norm(dim=-1, keepdim=True)


def teacher_cls(torch, model, tok, texts, max_length: int, device: str):
    enc = tok(texts, padding="max_length", truncation=True,
              max_length=max_length, return_tensors="np")
    ids, mask = (torch.from_numpy(enc[k]).to(device)
                 for k in ("input_ids", "attention_mask"))
    with torch.no_grad():
        return model.encode_cls(ids, mask).float(), ids, mask


def check_teacher(torch, teacher, shape: dict, texts, seed: int,
                  device: str) -> dict:
    """Check 4: the bf16 teacher's embeddings for ``texts`` (unit norm
    within TEACHER_NORM_ATOL); the same module in f32 against
    ``xlmr_plain_cls`` within TEACHER_F32_RTOL (a fault in the mask or the
    positions shows there); the bf16 embeddings' cosine with the f32
    module's held to twice a floor measured first: bf16 against f32 of a
    module with the weights of seed + 1."""
    import dataclasses

    from splade_tpu_torch.models.xlmr import XlmRobertaEncoder

    tok, L = teacher.tokenizer, teacher.max_length
    f32_cfg = dataclasses.replace(teacher.model.config, dtype=torch.float32)

    def bf16_vs_f32(bf16_model, f32_model):
        got = teacher_cls(torch, bf16_model, tok, texts, L, device)[0]
        want, ids, mask = teacher_cls(torch, f32_model, tok, texts, L, device)
        return got, want, ids, mask, float(
            (1 - (got * want).sum(-1)).max())

    other = xlmr_init(torch, f32_cfg, seed + 1, device)
    with torch.device(device):
        other_bf16 = XlmRobertaEncoder(teacher.model.config).eval()
    other_bf16.load_state_dict(other.state_dict())
    floor = bf16_vs_f32(other_bf16, other)[-1]
    del other, other_bf16
    tol = 2 * max(floor, 1e-7)
    with torch.device(device):
        f32 = XlmRobertaEncoder(f32_cfg).eval()
    f32.load_state_dict({k: v.float() for k, v in
                         teacher.model.state_dict().items()})
    got, want, ids, mask, worst = bf16_vs_f32(teacher.model, f32)
    with torch.no_grad():
        plain = xlmr_plain_cls(torch, f32.state_dict(), shape, ids, mask)
    plain_err = float((want - plain).abs().max() / plain.abs().max())
    norm_err = float((got.norm(dim=-1) - 1).abs().max())
    out = dict(texts=len(texts), valid_tokens=[int(x) for x in
                                               mask.sum(1).tolist()],
               norm_err=norm_err, f32_vs_plain_rel_err=plain_err,
               bf16_vs_f32_one_minus_cos=worst, floor_seed=seed + 1,
               floor=floor, tol=tol)
    log(f"  teacher, {len(texts)} texts at {L} tokens: unit norm within "
        f"{norm_err:.1e} (tol {TEACHER_NORM_ATOL}); f32 module vs the plain "
        f"f32 forward {plain_err:.2e} (tol {TEACHER_F32_RTOL}); bf16 vs f32 "
        f"1 - cos {worst:.3e}, tolerance {tol:.3e} = 2 x the floor {floor:.3e}"
        f" measured on seed {seed + 1}'s weights")
    if not norm_err <= TEACHER_NORM_ATOL:
        raise SystemExit("teacher: embeddings are not unit norm")
    if not plain_err <= TEACHER_F32_RTOL:
        raise SystemExit("teacher: the f32 module differs from the plain "
                         "XLM-R forward")
    if not worst <= tol:
        raise SystemExit("teacher: bf16 embeddings differ from f32 beyond "
                         "twice the measured floor")
    return out


def read_encodings(path) -> tuple:
    """The runner's --encodings npz, read as the runner reads it -> (doc
    ids, [(indices, values)] a document, [N, V] f64 CSR of them)."""
    from scipy import sparse

    from splade_tpu_torch.benchmark.runner import split_encodings

    doc_ids, vecs = split_encodings(np.load(path, allow_pickle=False))
    indptr = np.concatenate([[0], np.cumsum([len(i) for i, _ in vecs])])
    cat = lambda k: (np.concatenate([v[k] for v in vecs]) if vecs
                     else np.zeros(0))
    return doc_ids, vecs, sparse.csr_matrix(
        (cat(1).astype(np.float64), cat(0), indptr), shape=(len(vecs), V))


def ranking_tolerances(csr, q, method: str) -> np.ndarray:
    """[N] how far each document's score may lie from its exact f64 score
    in ``method``'s index on the query vector ``q`` [V]: 1e-5 of the score
    for f32 sums ('exact': the CSR index), plus the rounding of the weights
    the index stores. 'impact' (ImpactIndex, bf16): each product of two
    weights rounded to bf16 (each within 2^-8 of itself) within 2^-7 of its
    value. 'postings' (the
    doc-major block that the rescore reads: int8 weights with one scale a
    document, max |w| / 127): each weight within half a step, times the
    query weights of the document's terms."""
    aq = np.abs(q)
    slack = 1e-5 * np.abs(csr @ q)
    if method == "exact":
        return slack
    if method == "impact":
        return slack + 2.0 ** -7 * (abs(csr) @ aq)
    step = abs(csr).max(axis=1).toarray().ravel() / 127.0
    return slack + 0.5 * step * ((csr != 0).astype(np.float64) @ aq)


def check_rankings(what: str, lists: dict, query_vecs: dict, doc_ids,
                   csr, method: str, top_t: int = 0, k: int = 10,
                   allowed=None) -> dict:
    """Check 2: each query's top-k from an index (``lists``: query ->
    [(doc id, score)]) against the exact CSR search of the same vectors
    (the query cut to its ``top_t`` strongest terms first, when given, as
    the postings index cuts it). A list equal to the exact one is
    identical; otherwise every score it reports must lie within the
    index's rounding (``ranking_tolerances``) of its document's exact
    score, and at every rank its document's exact score within the two
    documents' tolerances of the exact ranking's: what differs is near a
    tie or the cut-off. ``allowed`` (query -> the document rows an
    approximate index rescored: its candidates) restricts the exact search
    to them; the share of the unrestricted exact top-k found is then
    reported as recall. -> counts, and the largest gap a differing rank
    had, relative to the query's top exact score."""
    row = {d: i for i, d in enumerate(doc_ids)}
    identical, differing, gap_max, gap_in_tol = 0, 0, 0.0, 0.0
    found, asked = 0, 0
    for query, got in lists.items():
        idx, val = (np.asarray(x) for x in query_vecs[query])
        if top_t and len(val) > top_t:
            keep = np.argsort(-val.astype(np.float32))[:top_t]
            idx, val = idx[keep], val[keep]
        q = np.zeros(V)
        np.add.at(q, idx.astype(np.int64), val.astype(np.float64))
        exact = csr @ q
        got_rows = [row[d] for d, _ in got]
        if allowed is not None:
            everywhere = np.lexsort((np.arange(len(exact)), -exact))[:k]
            best = {i for i in everywhere if exact[i] > 0}
            found += len(best & set(got_rows))
            asked += len(best)
            keep = np.zeros(len(exact), bool)
            keep[sorted(allowed[query])] = True
            exact = np.where(keep, exact, 0.0)
        order = np.lexsort((np.arange(len(exact)), -exact))
        want = [i for i in order[:k] if exact[i] > 0]
        tol = ranking_tolerances(csr, q, method)
        # entries past the exact list's end may only be documents scoring 0
        for (d, s), i in zip(got[len(want):], got_rows[len(want):]):
            if not abs(exact[i]) <= tol[i]:
                raise SystemExit(f"{what}: {d} of query {query!r} scores "
                                 f"{exact[i]:.6g} past the exact list's end")
        got, got_rows = got[:len(want)], got_rows[:len(want)]
        if len(got) < len(want):
            raise SystemExit(f"{what}: query {query!r}: {len(got)} results, "
                             f"the exact search has {len(want)}")
        for (d, s), i in zip(got, got_rows):
            if not abs(s - exact[i]) <= tol[i]:
                raise SystemExit(f"{what}: query {query!r}: {d} scored "
                                 f"{s:.6g}, exact {exact[i]:.6g} (tol "
                                 f"{tol[i]:.3g})")
        if got_rows == want:
            identical += 1
            continue
        differing += 1
        top = max(exact[want[0]], 1e-12)
        for g, w in zip(got_rows, want):
            gap = exact[w] - exact[g]
            if gap > tol[g] + tol[w]:
                raise SystemExit(
                    f"{what}: query {query!r}: rank holds {doc_ids[g]} "
                    f"({exact[g]:.6g}) where the exact ranking has "
                    f"{doc_ids[w]} ({exact[w]:.6g}), a gap beyond the "
                    f"index's rounding ({tol[g] + tol[w]:.3g})")
            gap_max = max(gap_max, gap / top)
            gap_in_tol = max(gap_in_tol, gap / max(tol[g] + tol[w], 1e-30))
    out = dict(queries=len(lists), identical=identical,
               within_rounding=differing, largest_gap_rel=gap_max,
               largest_gap_of_tol=gap_in_tol)
    if allowed is not None:
        out["recall"] = found / max(asked, 1)
    log(f"  {what}: top-{k} of {len(lists)} queries against the exact CSR "
        f"search on the same vectors"
        + (" over the candidates each query's search rescored"
           if allowed is not None else "")
        + f": {identical} identical, {differing} "
        f"differing only within the index's rounding (largest gap "
        f"{gap_max:.2e} of the top score, {gap_in_tol:.2f} of the "
        "tolerance)"
        + (f"; recall@{k} against the search over every document "
           f"{out['recall']:.3f} (printed, not held)"
           if allowed is not None else ""))
    return out


def cluster_unions(torch, index, query_vecs: dict, csr) -> dict:
    """query -> the document rows a ClusterIndex's search of that query
    vector rescores (its candidate union, the pad row left out), recorded
    at its one phase-2 rescore, where the clusters it probed are held
    against a plain reading of the documents ``csr``
    (``cluster_probe_check``)."""
    from splade_tpu_torch.ops import cluster_index

    dispatch, seen, probes = cluster_index.dispatch_rescore, [], []

    def recording(d_terms, d_vals, d_scale, q_idx, q_val, cand, *rest, **kw):
        seen.append(cand[0].tolist())
        # row 0 is the query; the rest pad the batch
        probes.append(cluster_probe_check(torch, index, csr, q_idx[:1],
                                          q_val[:1], cand[:1]))
        return dispatch(d_terms, d_vals, d_scale, q_idx, q_val, cand, *rest,
                        **kw)

    cluster_index.dispatch_rescore = recording
    unions = {}
    try:
        for query, (idx, val) in query_vecs.items():
            index.search_vector(np.asarray(idx, np.int32),
                                np.asarray(val, np.float32), k=10)
            unions[query] = {i for i in seen.pop() if i < len(index)}
    finally:
        cluster_index.dispatch_rescore = dispatch
    log(f"  cluster row's probes of {len(probes)} queries "
        f"({probes[0]['probes']} of {probes[0]['clusters']} clusters) == a "
        "plain f32 reading of the summaries: "
        f"{sum(p['tied_queries'] for p in probes)} queries with a cluster "
        "left out tied with one probed, largest gap "
        f"{max(p['max_gap'] for p in probes):.2e} of the top summary score "
        f"(tol {PROBE_RTOL})")
    return unions


def check_postings_rescore(torch, index, query_vecs: dict) -> dict:
    """Check 2b: the rescore kernel against its plain version at the shapes
    the postings row gives it. Each query vector (``query_vecs``: query ->
    (term ids, weights)) goes through ``index.search_vector``, as the
    row's searcher sends it; at each phase-2 rescore that search makes,
    the kernel's scores (``rescore_match``, which the search then goes on
    with) and ``rescore_match_plain``'s on the same doc-major block,
    query and candidates must agree within RESCORE_TOL of the larger of 1
    and the call's top score. -> the shapes, whether the kernel took its
    scalar path (rows of M % 8 != 0 terms), the largest error."""
    from splade_tpu_torch.ops import postings_index, rescore_kernel

    dispatch, calls = postings_index.dispatch_rescore, []

    def compared(d_terms, d_vals, d_scale, q_idx, q_val, cand, *rest, **kw):
        args = (d_terms, d_vals, d_scale, q_idx, q_val, cand)
        got = rescore_kernel.rescore_match(*args)
        want = rescore_kernel.rescore_match_plain(*args)
        top = max(1.0, float(want.abs().max()))
        calls.append((tuple(cand.shape), tuple(d_terms.shape),
                      q_idx.shape[1], float((got - want).abs().max()) / top))
        return got

    postings_index.dispatch_rescore = compared
    try:
        for idx, val in query_vecs.values():
            index.search_vector(np.asarray(idx, np.int32),
                                np.asarray(val, np.float32), k=10)
    finally:
        postings_index.dispatch_rescore = dispatch
    if len(calls) != len(query_vecs):
        raise SystemExit(f"postings rescore: {len(calls)} rescores for "
                         f"{len(query_vecs)} queries")
    shapes = sorted({c[:3] for c in calls})
    worst = max(c[3] for c in calls)
    M = shapes[0][1][1]
    out = dict(queries=len(calls), shapes=[
        f"B={b} C={c} N={n} M={m} T={t}" for (b, c), (n, m), t in shapes],
        M=M, scalar_path=M % 8 != 0, max_rel_err=worst, tol=RESCORE_TOL)
    log(f"  rescore at the postings row's shapes ({', '.join(out['shapes'])}"
        f"; the kernel's {'scalar' if out['scalar_path'] else 'vector'} "
        f"path, M % 8 = {M % 8}), {len(calls)} queries: kernel == "
        f"rescore_match_plain (max error {worst:.2e} of max(1, top score),"
        f" tol {RESCORE_TOL})")
    if not worst <= RESCORE_TOL:
        raise SystemExit("postings rescore: the kernel differs from its "
                         "plain version at the postings row's shapes")
    return out


def bench_entry(argv) -> int:
    """``python chip_smoke.py --cli [--model-config JSON] bench DUMP ARGS``
    (through ``cli_entry``, which puts the stand-in tokenizer in place of
    ``create_tokenizer``): the port's benchmark CLI
    (``python -m splade_tpu_torch.benchmark.runner ARGS``) with the dense
    stand-in tokenizer in place of the teacher's. It records what phase 8
    holds and writes it to DUMP as JSON: each sparse row's per-query list,
    the query vectors the encoder produced, the runner's failed queries,
    and the time of each batched encode."""
    import logging

    from splade_tpu_torch.benchmark import encoders, runner, searchers
    from splade_tpu_torch.models import teachers

    dump, argv = Path(argv[0]), argv[1:]
    teachers.teacher_tokenizer = DenseCharTokenizer.from_dir
    lists, encodes, failed, kept = {}, {}, [], []
    search = searchers.BaseSearcher.search

    def recording(self, query, k=10):
        res = search(self, query, k)
        if self.name in BENCH_SPARSE_ROWS:
            lists.setdefault(self.name, {})[query] = res.doc_scores
        return res

    def timed(name, fn):
        def run(self, texts):
            t0 = time.perf_counter()
            out = fn(self, texts)
            if len(texts) > 1:
                encodes.setdefault(name, []).append(
                    (len(texts), time.perf_counter() - t0))
            return out
        return run

    class Failures(logging.Handler):
        def emit(self, record):
            if str(record.msg).startswith("query %s failed on"):
                failed.append(record.getMessage())

    searchers.BaseSearcher.search = recording
    encoders.SparseEncoderV33.encode_documents = timed(
        "sparse_documents", encoders.SparseEncoderV33.encode_documents)
    encoders.TeacherDenseEncoder.encode = timed(
        "dense", encoders.TeacherDenseEncoder.encode)
    run = runner.BenchmarkRunner.run
    runner.BenchmarkRunner.run = lambda self: (kept.append(self),
                                               run(self))[1]
    logging.getLogger(runner.__name__).addHandler(Failures())
    rc = runner.main(argv)
    enc = kept[0].sparse_encoder
    dump.write_text(json.dumps({
        "lists": lists, "failed": failed, "encodes": encodes,
        "query_vectors": {q: [v[0].tolist(), v[1].tolist()]
                          for q, v in enc._query_cache.items()}}))
    return rc


def bench_launches(n_docs: int, distinct_queries: int,
                   rescored_queries: int) -> dict:
    """The launches one benchmark run implies: the pool forward once a
    document batch it encodes (BENCH_ENCODE_BATCH documents) and once a
    distinct query (the runner memoizes query encodes), the rescore once a
    query of each row that rescores (the postings and the cluster row), no
    training kernel."""
    return {**dict.fromkeys(_counted_kernels(), 0),
            "fused_splade_pool": -(-n_docs // BENCH_ENCODE_BATCH)
            + distinct_queries,
            "rescore_match": rescored_queries}


def bench_phase(torch, rng, workdir, seed: int, card: str,
                device: str = "cuda", n_triplets: int = BENCH_TRIPLETS,
                sample_size: int = BENCH_QUERIES,
                doc_words=BENCH_DOC_WORDS, sparse_over=None,
                dense_shape=None, dense_max_length: int = BENCH_DENSE_LEN,
                doc_nnz: int = BENCH_DOC_NNZ,
                query_nnz: int = BENCH_QUERY_NNZ, teacher_texts: int = 32,
                timeout_s: float = BENCH_TIMEOUT_S, cli=None) -> dict:
    """Phase 8: the port's benchmark CLI on the card, at full width, and the
    teacher tier's precompute and mining (see the module's docstring).
    ``cli``: the command that runs ``cli_entry`` (the tests run faulty
    versions of the port through their own); ``sparse_over`` and
    ``dense_shape``: the models' widths (the CPU rehearsal's tiny ones)."""
    import shutil

    from splade_tpu_torch.benchmark.data import load_triplet_benchmark
    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.benchmark.runner import (benchmark_cluster_index,
                                                   serving_postings_index)
    from splade_tpu_torch.mining import (mine_multi_negatives,
                                         precompute_teacher_scores)
    from splade_tpu_torch.models.teachers import BGEM3Teacher
    from splade_tpu_torch.models.xlmr import XlmRobertaConfig

    t_phase = time.perf_counter()
    shape = dense_shape or bge_m3_shape()
    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    rows = bench_triplets(rng, n_triplets, doc_words)
    with open(workdir / "triplets.jsonl", "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    tok = CharTokenizer()

    # the sparse model, its bias calibrated on a sample, as a model.pt dir
    t0 = time.perf_counter()
    docs = [r["positive"] for r in rows[:32]] + [r["negatives"][0]
                                                 for r in rows[:32]]
    queries = [r["query"] for r in rows[:64]]
    model, shift, nnz = sparse_bench_model(
        torch, tok, docs, queries, seed, device, sparse_over, doc_nnz,
        query_nnz)
    (workdir / "sparse").mkdir()
    torch.save(model.state_dict(), workdir / "sparse" / "model.pt")
    log(f"  sparse model: SpladeEncoder {model.config.num_hidden_layers}L/"
        f"{model.config.hidden_size}/{model.config.vocab_size}, seeded "
        f"random weights (seed {seed}), bf16, decoder bias -{shift:.4f}: "
        f"{nnz['docs']:.0f} nonzeros a document and {nnz['queries']:.0f} a "
        f"query on the sample")
    # the dense model at BGE-M3's shape, as an HF dir
    dense_cfg = XlmRobertaConfig(**shape)
    dense = xlmr_init(torch, dense_cfg, seed, device)
    write_dense_checkpoint(torch, dense, shape, workdir / "dense")
    del dense
    log(f"  dense model: XLM-R {shape['num_hidden_layers']}L/"
        f"{shape['hidden_size']}/{shape['vocab_size']}"
        + (" (BGE-M3's shape)" if dense_shape is None else "")
        + f", seeded random weights, written in "
        f"{time.perf_counter() - t0:.1f} s with the sparse one")

    # runs (a) and (b): the CLI in processes of its own
    cli = cli or [sys.executable, str(Path(__file__).resolve()), "--cli"]
    head = cli + (["--model-config", json.dumps(sparse_over)]
                  if sparse_over else [])
    common = ["--dataset", "triplet-val",
              "--val-files", str(workdir / "triplets.jsonl"),
              "--sample-size", str(sample_size),
              "--checkpoint", str(workdir / "sparse"),
              "--encodings", str(workdir / "encodings.npz"),
              "--device", device]
    runs = {
        "a": ["--index", "exact", "--postings-index", "--cluster-index",
              "--dense-checkpoint", str(workdir / "dense"),
              "--dense-max-length", str(dense_max_length)],
        "b": ["--index", "gpu", "--no-hybrid"]}
    out = {}
    for name, args in runs.items():
        t0 = time.perf_counter()
        text = run_processes(
            f"benchmark run ({name})",
            [head + ["bench", str(workdir / f"{name}.json")] + common + args
             + ["--output-dir", str(workdir / name)]],
            [repo_env()], [workdir / f"{name}.log"], timeout_s)[0]
        out[name] = dict(
            seconds=time.perf_counter() - t0,
            launches=json.loads([ln for ln in text.splitlines()
                                 if ln.startswith("LAUNCHES ")][-1][9:]),
            metrics=json.loads((workdir / name / "metrics.json").read_text()),
            **json.loads((workdir / f"{name}.json").read_text()))

    # check 1: every method, no failed query
    for name, want in (("a", BENCH_METHODS), ("b", BENCH_GPU_METHODS)):
        got = set(out[name]["metrics"]["methods"])
        if got != want:
            raise SystemExit(f"benchmark run ({name}): methods {sorted(got)},"
                             f" expected {sorted(want)}")
        if out[name]["failed"]:
            raise SystemExit(f"benchmark run ({name}): "
                             f"{len(out[name]['failed'])} queries failed: "
                             f"{out[name]['failed'][:3]}")
    n_queries = out["a"]["metrics"]["num_queries"]
    n_docs = out["a"]["metrics"]["num_docs"]
    log(f"  runs (a) exact + postings + cluster + dense, (b) ImpactIndex: "
        f"{n_queries} queries over {n_docs} documents, every method "
        f"({len(BENCH_METHODS)} | {len(BENCH_GPU_METHODS)}), 0 failed "
        "queries")

    # check 2: the device indexes against the exact CSR search
    doc_ids, vecs, csr = read_encodings(workdir / "encodings.npz")
    rankings = {
        "neural_sparse_postings": check_rankings(
            "run (a) neural_sparse_postings (PostingsIndex + rescore)",
            out["a"]["lists"]["neural_sparse_postings"],
            out["a"]["query_vectors"], doc_ids, csr, "postings",
            top_t=POSTINGS_QUERY_TOP_T),
        # an approximate index: ranked exactly within the candidates each
        # search rescored (its union, rebuilt below from the encodings with
        # the runner's configuration), with the postings row's rounding
        "neural_sparse_cluster": check_rankings(
            "run (a) neural_sparse_cluster (ClusterIndex + rescore)",
            out["a"]["lists"]["neural_sparse_cluster"],
            out["a"]["query_vectors"], doc_ids, csr, "postings",
            top_t=POSTINGS_QUERY_TOP_T, allowed=cluster_unions(
                torch, benchmark_cluster_index(len(tok), doc_ids, vecs,
                                               device),
                out["a"]["query_vectors"], csr)),
        "neural_sparse (exact)": check_rankings(
            "run (a) neural_sparse (exact CSR)",
            out["a"]["lists"]["neural_sparse"], out["a"]["query_vectors"],
            doc_ids, csr, "exact"),
        "neural_sparse (gpu)": check_rankings(
            "run (b) neural_sparse (ImpactIndex)",
            out["b"]["lists"]["neural_sparse"], out["b"]["query_vectors"],
            doc_ids, csr, "impact")}
    q_nnz = [len(v[0]) for v in out["a"]["query_vectors"].values()]
    doc_nnz_run = np.diff(csr.indptr)

    # check 5: launches as the code implies; the dataset as the CLI loads it
    data = load_triplet_benchmark(str(workdir / "triplets.jsonl"),
                                  sample_size)
    distinct = len(set(data.queries.values()))
    launches = {name: out[name]["launches"] for name in runs}
    want = {"a": bench_launches(len(data.corpus), distinct,
                                2 * len(data.queries)),
            "b": bench_launches(0, distinct, 0)}
    for name in runs:
        hold_launches(f"benchmark run ({name})", launches[name],
                      launches_on(device, want[name]))

    # check 3: the kernels against their plain versions at this path's
    # shapes: document batches, a query alone, the postings row's rescores
    enc = SparseEncoderV33(model, tok, device=device)
    doc_encode_diff = compare_doc_encode(torch, enc, model,
                                         list(data.corpus.values())[:64])
    query_encode_diff = compare_doc_encode(
        torch, enc, model, list(data.queries.values())[:BENCH_QUERY_CHECK],
        enc.query_max_length, 1, "query")
    del enc, model
    postings_rescore = check_postings_rescore(
        torch, serving_postings_index(len(tok), doc_ids, vecs, device),
        out["a"]["query_vectors"])

    # check 4: the teacher
    dense_tok = DenseCharTokenizer.from_dir(workdir / "dense")
    teacher = BGEM3Teacher.from_hf_dir(str(workdir / "dense"),
                                       tokenizer=dense_tok, device=device,
                                       max_length=dense_max_length)
    texts = [r["query"] for r in rows[:teacher_texts // 2]] + [
        r["positive"] for r in rows[:teacher_texts - teacher_texts // 2]]
    teacher_check = check_teacher(torch, teacher, shape, texts, seed, device)

    # (c) teacher scores over every triplet, the cache reused, mining
    t0 = time.perf_counter()
    meta = precompute_teacher_scores(str(workdir / "triplets.jsonl"),
                                     str(workdir / "scored.jsonl"), teacher,
                                     cache_dir=str(workdir / "cache"))
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    teacher_s = time.perf_counter() - t0

    class NoEncode:
        def encode(self, texts):
            raise SystemExit("the second precompute encoded: the cache was "
                             "not reused")

    meta2 = precompute_teacher_scores(str(workdir / "triplets.jsonl"),
                                      str(workdir / "scored.jsonl"),
                                      NoEncode(),
                                      cache_dir=str(workdir / "cache"))
    mined = mine_multi_negatives(str(workdir / "scored.jsonl"),
                                 str(workdir / "mined.jsonl"),
                                 str(workdir / "cache"),
                                 num_negatives=BENCH_NEGATIVES)
    check_mined(workdir / "scored.jsonl", workdir / "mined.jsonl",
                n_triplets, BENCH_NEGATIVES)
    if (meta["scored"], meta2["scored"]) != (n_triplets, n_triplets):
        raise SystemExit(f"teacher precompute scored {meta['scored']} and "
                         f"{meta2['scored']} of {n_triplets} rows")
    del teacher

    # item 7: rates and latencies beside the card
    def per_s(name):
        n, s = map(sum, zip(*out["a"]["encodes"][name]))
        return n / s

    latency = {f"{run} {m}": (v["latency_p50_ms"], v["latency_p99_ms"])
               for run in runs for m, v in sorted(
                   out[run]["metrics"]["methods"].items())}
    result = dict(
        card=card, device=device, queries=n_queries, documents=n_docs,
        sparse_docs_per_s=per_s("sparse_documents"),
        dense_docs_per_s=per_s("dense"), dense_max_length=dense_max_length,
        latency_p50_p99_ms=latency,
        teacher_texts=meta["unique_texts"],
        teacher_texts_per_s=meta["unique_texts"] / teacher_s,
        mined=mined, decoder_bias=-shift,
        doc_nnz_mean=float(doc_nnz_run.mean()),
        query_nnz_mean=float(np.mean(q_nnz)),
        queries_over_postings_top_t=int(sum(n > POSTINGS_QUERY_TOP_T
                                            for n in q_nnz)),
        rankings=rankings, launches=launches, doc_encode_max_rel_diff=(
            doc_encode_diff), query_encode_max_rel_diff=query_encode_diff,
        postings_rescore=postings_rescore, teacher=teacher_check,
        run_seconds={name: out[name]["seconds"] for name in runs},
        recall_at_1={m: v["recall@1"] for m, v in
                     out["a"]["metrics"]["methods"].items()},
        seconds=time.perf_counter() - t_phase)
    log(f"  {card}: sparse {result['sparse_docs_per_s']:.1f} documents/s "
        f"(S=256), dense {result['dense_docs_per_s']:.1f} documents/s at "
        f"{dense_max_length} tokens, teacher {result['teacher_texts_per_s']:.1f}"
        f" texts/s over {meta['unique_texts']} texts in (c); documents hold "
        f"{result['doc_nnz_mean']:.0f} nonzeros, queries "
        f"{result['query_nnz_mean']:.1f} ({result['queries_over_postings_top_t']}"
        f" over the postings row's {POSTINGS_QUERY_TOP_T}); runs "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in
                    result["run_seconds"].items()))
    log("  latency p50 / p99 ms: " + "; ".join(
        f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in latency.items()))
    log("  recall@1 with random weights (measures nothing of the method): "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    sorted(result["recall_at_1"].items())))
    shutil.rmtree(workdir, ignore_errors=True)
    return result


def check_mined(scored_path, mined_path, n_rows: int, negatives: int) -> None:
    """Check 6: teacher scores in [-1.01, 1.01]; every mined row has
    ``negatives`` negatives and as many teacher scores, none of them its
    own positive."""
    scored = [json.loads(ln) for ln in
              Path(scored_path).read_text().splitlines()]
    mined = [json.loads(ln) for ln in
             Path(mined_path).read_text().splitlines()]
    scores = [s for r in scored for s in
              [r["teacher_pos_score"]] + r["teacher_neg_scores"]]
    if len(mined) != n_rows or not all(-1.01 <= s <= 1.01 for s in scores):
        raise SystemExit("teacher scores out of [-1.01, 1.01], or rows lost")
    for r in mined:
        if (len(r.get("negatives", [])) != negatives
                or len(r.get("teacher_neg_scores", [])) != negatives
                or r["positive"] in r["negatives"]):
            raise SystemExit(f"mined row malformed: {str(r)[:300]}")
    log(f"  (c) teacher scores of {len(scored)} rows within [-1.01, 1.01]; "
        f"{len(mined)} rows mined with {negatives} negatives and their "
        "scores each, no positive among its negatives")


# ------------------------------------------------------------ phase 9
#: phase 9's indexes over phase 3's corpus
TIERED_CONFIG = dict(n_postings=256, hot_terms=2048, hot_postings=8192,
                     query_top_t=64, rescore_candidates=1000)
CLUSTER_CONFIG = dict(cluster_size=64, n_probes=32, posting_cap=64,
                      posting_candidates=128, query_top_t=64)
#: (a) the documents both the saved and the exported model encode
EXPORT_CHECK_DOCS = 64
#: documents the exported model encodes into phase 9's indexes, and the
#: terms each keeps (phase 3's encoder)
SERVE_TEXT_DOCS, SERVE_DOC_TOP_K = 256, 64
SERVE_QUERIES = 32
#: (c) the rescore kernel against its plain version on the cluster union:
#: one f32 sum a candidate in another order, relative to max(1, top score)
CLUSTER_RESCORE_TOL = 1e-6
#: (c) and phase 8's cluster row: the probed clusters against a plain
#: reading of the summaries, ties allowed within this share of the query's
#: top summary score (f32 sums of up to T bf16 products in another order)
PROBE_RTOL = 1e-5
#: (d) the server CLI's corpus
CLI_DOCS = 2000
SERVE_TIMEOUT_S = 300.0
#: (d) each index the server CLI builds, and what it is asked for
CLI_INDEXES = {"tiered": ["--index", "tiered", "--rescore", "1000"],
               "cluster": ["--index", "cluster", "--posting-scoring",
                           "sort"]}


def export_check(torch, tok, final_dir, out_dir, texts, device: str,
                 cli, model_config=None,
                 timeout_s: float = SERVE_TIMEOUT_S) -> tuple:
    """Phase 9 (a): the export CLI on a saved model in a process of its own
    (``cli``: the command that runs ``cli_entry``), then the dir's files
    (the port's reader parses the safetensors header), every saved tensor
    bitwise through ``load_hf_checkpoint`` and no other, and ``texts``
    encoded by the exported model bitwise the saved model's vectors and
    within SERVE_RTOL of the plain route. -> (result, the exported
    model's encoder)."""
    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.models.hf_port import load_hf_checkpoint
    from splade_tpu_torch.train.checkpoint import load_model_state
    from splade_tpu_torch.utils import safetensors_io

    out_dir = Path(out_dir)
    # the heads are not in the weights: a config other than the
    # architecture's names them (the window is the architecture's)
    heads = (["--num-attention-heads", str(model_config.num_attention_heads)]
             if model_config is not None else [])
    t0 = time.perf_counter()
    run_processes("export", [cli + ["export", "--checkpoint", str(final_dir),
                                    "--output", str(out_dir)] + heads],
                  [repo_env()], [out_dir.parent / "export.log"], timeout_s)
    export_s = time.perf_counter() - t0
    files = sorted(p.name for p in out_dir.iterdir())
    if not {"config.json", "model.safetensors"} <= set(files):
        raise SystemExit(f"export: the HF dir holds {files}")
    entries, meta, _ = safetensors_io.read_header(
        (out_dir / "model.safetensors").read_bytes())
    hf_cfg = json.loads((out_dir / "config.json").read_text())
    saved = load_model_state(str(final_dir))
    cfg, state = load_hf_checkpoint(str(out_dir))
    layers = len({k.split(".")[2] for k in saved
                  if k.startswith("model.layers.")})
    differ = sorted(k for k in set(saved) | set(state)
                    if k not in saved or k not in state
                    or not torch.equal(saved[k], state[k]))
    log(f"  export CLI in {export_s:.1f} s: {files}; model.safetensors "
        f"{(out_dir / 'model.safetensors').stat().st_size / 1e6:.1f} MB, "
        f"{len(entries)} tensors, metadata {meta}; config "
        f"{hf_cfg['num_hidden_layers']}L/{hf_cfg['hidden_size']}/"
        f"{hf_cfg['vocab_size']} (saved model: {layers} layers); reloaded "
        f"through load_hf_checkpoint: {len(saved) - len(differ)} of "
        f"{len(saved)} saved tensors bitwise, differing or missing "
        f"{differ[:4]}")
    if differ or cfg.num_hidden_layers != layers or meta != {"format": "pt"}:
        raise SystemExit("export: the reloaded model is not the saved one")
    saved_enc = SparseEncoderV33.from_checkpoint(str(final_dir), tok,
                                                 device=device,
                                                 config=model_config)
    enc = SparseEncoderV33.from_hf_dir(str(out_dir), tok, device=device)
    same = True
    with torch.no_grad():
        for i in range(0, len(texts), enc.batch_size):
            batch = enc.tokenize(texts[i:i + enc.batch_size],
                                 enc.doc_max_length)
            same &= bool(torch.equal(enc.encode_tensor(*batch),
                                     saved_enc.encode_tensor(*batch)))
    log(f"  {len(texts)} documents (B={enc.batch_size}, "
        f"S={enc.doc_max_length}) encoded by the exported model bitwise the "
        f"saved model's vectors: {same}")
    if not same:
        raise SystemExit("export: the exported model encodes differently")
    del saved_enc
    diff = compare_doc_encode(torch, enc, enc.model, texts)
    return dict(export_s=export_s, files=files, tensors=len(entries),
                layers=cfg.num_hidden_layers,
                safetensors_bytes=(out_dir / "model.safetensors"
                                   ).stat().st_size,
                bitwise=True, doc_encode_max_rel_diff=diff), enc


def exact_topk_ids(csr, query_vecs, doc_ids, k: int = 10) -> list:
    """Each query vector's exact top-k document ids over a CSR [N, V]."""
    out = []
    for idx, val in query_vecs:
        q = np.zeros(csr.shape[1], np.float32)
        np.add.at(q, np.asarray(idx, np.int64), np.asarray(val, np.float32))
        scores = csr @ q
        top = np.argsort(-scores, kind="stable")[:k]
        out.append([doc_ids[i] for i in top if scores[i] > 0])
    return out


def no_duplicates(name: str, lists) -> None:
    for res in lists:
        ids = [d for d, _ in res]
        if len(ids) != len(set(ids)):
            raise SystemExit(f"{name}: a result list holds a document twice:"
                             f" {ids[:12]}")


def serve_index(torch, name: str, index, enc, tok, queries, doc_text: str,
                exact, profile_dir, device: str, rescores_per_batch: int = 1,
                engine=None) -> dict:
    """Phase 9 (b) and (c), phase 10: ``index`` (built) served behind the
    HTTP server (``drive``; by ``engine`` where one is given), its launches
    counted around the path alone and held at one pool forward and
    ``rescores_per_batch`` rescores a batch (one a shard on a mesh, none
    for the dense index); no result list holding a document twice;
    recall@10 against the exact search (``exact``: (csr, doc ids)),
    printed; one warmed B=32 batch under ``profile_fn``.
    -> (result, the engine)."""
    from splade_tpu_torch.serving.engine import ServingEngine
    from splade_tpu_torch.utils.profiling import profile_fn

    if engine is None:
        engine = ServingEngine(enc.model, tok, index, query_top_k=64,
                               device=device)
    n_docs = len(index)  # before drive's /index adds one
    k10 = engine.search_batch(queries, k=10)
    no_duplicates(f"{name} k=10", k10)
    no_duplicates(f"{name} k=100", engine.search_batch(queries, k=100))
    q_vecs = enc.encode_queries(queries)
    want = exact_topk_ids(exact[0], q_vecs, exact[1])
    recall = float(np.mean([len({d for d, _ in got} & set(w)) / max(len(w), 1)
                            for got, w in zip(k10, want)]))
    served = drive(name, engine, enc.model, queries, doc_text)
    per_batch = {k: v["per_batch"] for k, v in
                 served["kernel_launches"].items()}
    want = {"fused_splade_pool": 1.0, "rescore_match": rescores_per_batch}
    if device.startswith("cuda") and per_batch != want:
        raise SystemExit(f"{name}: launches a batch {per_batch}, expected "
                         f"one pool forward and {rescores_per_batch} "
                         "rescores")
    prof = profile_fn(engine.search_batch, (queries[:32], 100),
                      str(profile_dir), steps=1)
    top = list(prof["top_kernels_ms"].items())
    log(f"  {name}: recall@10 against the exact search over "
        f"{len(queries)} queries {recall:.3f} (printed, not held); one "
        f"warmed B={len(queries[:32])} k=100 batch under profile_fn: wall "
        f"{prof['wall_ms']:.2f} ms"
        + (f", device busy {prof['device_busy_ms']:.2f} ms (idle "
           f"{prof['device_idle_share']:.1%}) over {prof['device_ops']} "
           "device ops; top: " + ", ".join(f"{k[:40]} {v:.3f}"
                                          for k, v in top[:5])
           if prof["device_busy_ms"] is not None
           else "; the profiler saw no device activity, not measured"))
    return dict(served=served, recall_at_10=recall, profile=prof,
                docs=n_docs), engine


def union_rescore_stats(torch, d_terms, d_vals, d_scale, q_idx, q_val,
                        cand, got, want) -> dict:
    """The rescore kernel's scores ``got`` on a union of candidates against
    its plain version's ``want``: the largest difference relative to
    max(1, the top score), the pad candidates (doc id n, the block's last
    row) and those scoring other than 0, the duplicated candidates and the
    copies scoring other than their first."""
    B, C = cand.shape
    N, M = d_terms.shape
    T = q_idx.shape[1]
    err = float((got - want).abs().max()) / max(1.0,
                                                float(want.abs().max()))
    pad = cand == N - 1
    ids, perm = torch.sort(cand, dim=1, stable=True)
    sc = got.gather(1, perm)
    dup = ids[:, 1:] == ids[:, :-1]
    return dict(shape=f"B={B} C={C} M={M} T={T} N={N}", max_abs_err=err,
                tol=CLUSTER_RESCORE_TOL, pad_candidates=int(pad.sum()),
                duplicate_candidates=int(dup.sum()),
                pad_nonzero=int((got[pad] != 0).sum()),
                duplicates_unequal=int(
                    (dup & (sc[:, 1:] != sc[:, :-1])).sum()))


def union_rescore_check(torch, d_terms, d_vals, d_scale, q_idx, q_val,
                        cand, got, want) -> dict:
    """``union_rescore_stats`` on a cluster union, held: within
    CLUSTER_RESCORE_TOL of max(1, the top score), every pad candidate
    scoring 0, every copy of a duplicated candidate bitwise its first's;
    the union must hold pad slots and duplicates."""
    N = d_terms.shape[0]
    out = union_rescore_stats(torch, d_terms, d_vals, d_scale, q_idx, q_val,
                              cand, got, want)
    err, pad_nonzero = out["max_abs_err"], out["pad_nonzero"]
    dup_unequal = out["duplicates_unequal"]
    log(f"  cluster rescore at {out['shape']} (the union: "
        f"{out['duplicate_candidates']} duplicate candidates, "
        f"{out['pad_candidates']} pad slots = doc id {N - 1}): kernel == "
        f"rescore_match_plain within {err:.2e} of max(1, top score) (tol "
        f"{CLUSTER_RESCORE_TOL}); pad candidates scoring other than 0: "
        f"{pad_nonzero}; duplicate copies scoring other than their first: "
        f"{dup_unequal}")
    if not (err <= CLUSTER_RESCORE_TOL and pad_nonzero == 0
            and dup_unequal == 0 and out["pad_candidates"] > 0
            and out["duplicate_candidates"] > 0):
        raise SystemExit("cluster rescore: the kernel differs from its plain "
                         "version on the union, or a pad or duplicate "
                         "candidate scores wrong")
    return out


def cluster_probe_check(torch, index, csr, q_idx, q_val, cand) -> dict:
    """The clusters a ClusterIndex's phase 1a probed, read from the union
    ``cand`` [B, L*G (+ C_p)] it handed the rescore (G slots a probed
    cluster's member row), against plain numpy: the member rows copied from
    the device (they must partition the n documents, pad id n), each
    cluster's summary of the queries' terms recomputed from ``csr`` (the
    index's documents in its order: the max of the members' weights,
    rounded to bf16 as the index stores it), dotted in f32 with the query
    rounded to bf16. Held: each probed row is its cluster's whole member
    row, no cluster probed twice, and no cluster left out scoring more
    than PROBE_RTOL of the query's top summary score above one probed. A
    fault in the summary product, the top-L or the member gather fails
    it."""
    cdocs = index._built[1].cpu().numpy()
    K, G = cdocs.shape
    n, vocab = index._base_n, index.vocab_size
    L = min(index.n_probes, K)
    real = cdocs < n
    if not np.array_equal(np.sort(cdocs[real]), np.arange(n)):
        raise SystemExit("cluster probes: the member rows do not partition "
                         "the documents")
    cluster_of = np.empty(n, np.int64)
    cluster_of[cdocs[real]] = np.nonzero(real)[0]
    bf16 = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()
    qi = q_idx.cpu().numpy().astype(np.int64)
    B = len(qi)
    qd = np.zeros((B, vocab + 1), np.float32)
    np.add.at(qd, (np.arange(B)[:, None], qi), q_val.float().cpu().numpy())
    qd = bf16(qd[:, :vocab])
    terms = np.flatnonzero(qd.any(0))
    sub = (csr if csr.shape[0] == n else csr[:n])[:, terms].tocoo()
    summary = np.zeros((len(terms), K), np.float32)
    np.maximum.at(summary, (sub.col, cluster_of[sub.row]),
                  sub.data.astype(np.float32))
    ref = qd[:, terms] @ bf16(summary)                      # [B, K] f32
    rows = cand[:, :L * G].cpu().numpy().reshape(B, L, G)
    if (rows[:, :, 0] >= n).any():
        raise SystemExit("cluster probes: a probed row starts with the pad "
                         "id")
    probed = cluster_of[rows[:, :, 0]]
    if not np.array_equal(rows, cdocs[probed]):
        raise SystemExit("cluster probes: a probed row is not one cluster's "
                         "member row")
    gaps = []
    for b in range(B):
        if len(set(probed[b].tolist())) != L:
            raise SystemExit(f"cluster probes: query {b} probes a cluster "
                             "twice")
        left = np.ones(K, bool)
        left[probed[b]] = False
        best_left = ref[b][left].max() if left.any() else -np.inf
        gaps.append(float(best_left - ref[b][probed[b]].min())
                    / max(float(ref[b].max()), np.finfo(np.float32).tiny))
    out = dict(queries=B, clusters=K, probes=L, max_gap=max(gaps),
               tied_queries=sum(g >= 0 for g in gaps), tol=PROBE_RTOL)
    if out["max_gap"] > PROBE_RTOL:
        raise SystemExit(f"cluster probes: a cluster left out scores "
                         f"{out['max_gap']:.2e} of the top summary score "
                         f"above one probed (tol {PROBE_RTOL})")
    return out


def cluster_rescore_check(torch, engine, queries, csr) -> dict:
    """Phase 9 (c): at one batched search, the rescore kernel on the union
    the cluster index hands it (``rescore_match``, which the search goes on
    with) against ``rescore_match_plain`` on the same doc-major block,
    queries and candidates (``union_rescore_check``, before the search goes
    on), and the clusters that union probed against a plain reading of the
    index's documents ``csr`` (``cluster_probe_check``). On the card, the
    kernel's time in a CUDA graph beside its byte bound and the plain
    version's time at these shapes."""
    from splade_tpu_torch.ops import cluster_index, rescore_kernel

    dispatch, calls = cluster_index.dispatch_rescore, []

    def compared(d_terms, d_vals, d_scale, q_idx, q_val, cand, *rest, **kw):
        args = (d_terms, d_vals, d_scale, q_idx, q_val, cand)
        got = rescore_kernel.rescore_match(*args)
        calls.append((args, union_rescore_check(
            torch, *args, got, rescore_kernel.rescore_match_plain(*args))))
        return got

    cluster_index.dispatch_rescore = compared
    try:
        engine.search_batch(queries, k=10)
    finally:
        cluster_index.dispatch_rescore = dispatch
    if len(calls) != 1:
        raise SystemExit(f"cluster rescore: {len(calls)} rescores in one "
                         "batch")
    (d_terms, d_vals, d_scale, q_idx, q_val, cand), out = calls[0]
    probes = cluster_probe_check(torch, engine.index, csr, q_idx, q_val, cand)
    log(f"  cluster probes of {probes['queries']} queries ({probes['probes']}"
        f" of {probes['clusters']} clusters) == a plain f32 reading of the "
        f"summaries: {probes['tied_queries']} queries with a cluster left "
        f"out tied with one probed, largest gap {probes['max_gap']:.2e} of "
        f"the top summary score (tol {PROBE_RTOL})")
    out = dict(out, probes=probes)
    if not cand.is_cuda:
        return dict(out, ms=None, plain_ms=None, bound_ms=None,
                    bound_by=None, library_ms=None)
    timed, _ = time_rescore(torch, d_terms, d_vals, d_scale, q_idx, q_val,
                            cand, plain_iters=3)
    log(f"  cluster rescore: kernel {timed['ms']:.5f} ms in a CUDA graph, "
        f"plain match {timed['plain_ms']:.4f} ms, "
        f"{rescore_bound_text(timed)}")
    return dict(out, **timed)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_cli_runs(what: str, commands, logs, queries,
                   timeout_s: float) -> list:
    """Start each server command (``--port`` given), wait until every one
    answers /healthz, send each the batched /search at k=10 and k=100, stop
    them (SIGINT, the server's clean stop; killed if they linger). -> per
    server: {k: results}, its log's text."""
    procs, out = [], []
    try:
        for cmd, path in zip(commands, logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT,
                                              env=repo_env()))
        deadline = time.monotonic() + timeout_s
        for cmd, proc in zip(commands, procs):
            addr = ("127.0.0.1", int(cmd[cmd.index("--port") + 1]))
            while True:
                if proc.poll() is not None:
                    raise SystemExit(f"{what}: a server exited "
                                     f"{proc.returncode} before it served")
                if time.monotonic() > deadline:
                    raise SystemExit(f"{what}: a server did not answer in "
                                     f"{timeout_s:.0f} s")
                try:
                    _http(addr, "GET", "/healthz")
                    break
                except OSError:
                    time.sleep(0.5)
            results = {}
            for k in (10, 100):
                got, _ = _http(addr, "POST", "/search",
                               {"queries": queries, "k": k})
                results[k] = [[(r["doc_id"], r["score"]) for r in rs]
                              for rs in got["results"]]
            out.append(results)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return out, [Path(p).read_text() for p in logs]


def cli_launches(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("LAUNCHES ")]
    return json.loads(lines[-1][9:]) if lines else {}


def server_cli_check(workdir, export_dir, texts, queries, device: str, cli,
                     timeout_s: float = SERVE_TIMEOUT_S) -> dict:
    """Phase 9 (d): the server CLI (``cli`` + ``serve``) from the export
    dir over ``texts`` as a JSONL corpus, once a CLI_INDEXES entry with its
    ``--index-cache`` (the servers run at once), then each restarted from
    its cache alone. Held: each cache records the kind asked for; each
    restart logs that it loaded that kind and returns the cold run's
    results (compare_served)."""
    from splade_tpu_torch.ops.postings_index import PostingsIndex

    workdir = Path(workdir)
    docs = workdir / "cli_docs.jsonl"
    docs.write_text("\n".join(json.dumps({"id": f"cli{i}", "text": t},
                                         ensure_ascii=False)
                              for i, t in enumerate(texts)))
    head = lambda kind: cli + [
        "serve", "--checkpoint", str(export_dir), "--device", device,
        "--host", "127.0.0.1", "--port", str(free_port()), "--index-cache",
        str(workdir / f"{kind}.npz")]
    kinds = list(CLI_INDEXES)
    t0 = time.perf_counter()
    cold, cold_logs = serve_cli_runs(
        "server CLI (cold)",
        [head(k) + ["--docs", str(docs)] + CLI_INDEXES[k] for k in kinds],
        [workdir / f"{k}_cold.log" for k in kinds], queries, timeout_s)
    cold_s = time.perf_counter() - t0
    for kind in kinds:
        with np.load(workdir / f"{kind}.npz", allow_pickle=False) as z:
            got = PostingsIndex.sniff_kind(z)
        if got != kind:
            raise SystemExit(f"server CLI: --index {kind} wrote a {got!r} "
                             "cache")
    t0 = time.perf_counter()
    warm, warm_logs = serve_cli_runs(
        "server CLI (from the cache)", [head(k) for k in kinds],
        [workdir / f"{k}_warm.log" for k in kinds], queries, timeout_s)
    warm_s = time.perf_counter() - t0
    result = dict(cold_s=cold_s, warm_s=warm_s, docs=len(texts))
    for kind, c, w, text in zip(kinds, cold, warm, warm_logs):
        sniffed = re.findall(r"loading persisted (\w+) index", text)
        if sniffed != [kind]:
            raise SystemExit(f"server CLI: the restart from a {kind} cache "
                             f"loaded {sniffed}")
        for k in (10, 100):
            no_duplicates(f"server CLI {kind} k={k}", c[k] + w[k])
            compare_served(f"server CLI {kind} k={k} (the restart from the "
                           "cache as served, the cold run as plain)", w[k],
                           c[k])
        result[kind] = dict(sniffed=sniffed[0], results=sum(
            len(r) for r in w[10]))
    result["launches"] = [cli_launches(t) for t in cold_logs + warm_logs]
    log(f"  server CLI from the export dir over {len(texts)} documents: "
        f"{', '.join(kinds)} built with --index-cache in {cold_s:.1f} s "
        f"(both at once), restarted from the caches in {warm_s:.1f} s; "
        "each cache holds its kind and each restart loaded it and answered "
        "as the cold run")
    return result


def serve_phase(torch, tok, rng, workdir, final_dir, syn_terms, syn_vals,
                card: str, device: str = "cuda", model_config=None,
                tiered=TIERED_CONFIG, cluster=CLUSTER_CONFIG,
                n_text_docs: int = SERVE_TEXT_DOCS,
                n_queries: int = SERVE_QUERIES, cli_docs: int = CLI_DOCS,
                cli=None, timeout_s: float = SERVE_TIMEOUT_S) -> dict:
    """Phase 9: train -> HF export -> serve (see the module's docstring).
    ``final_dir``: the saved model (phase 5's); ``syn_terms``/``syn_vals``:
    phase 3's corpus; ``cli``: the command that runs ``cli_entry`` (the
    tests run faulty versions through their own); ``model_config`` and the
    index configs: the CPU rehearsal's tiny ones."""
    import shutil

    from scipy import sparse

    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.ops.cluster_index import ClusterIndex
    from splade_tpu_torch.ops.tiered_postings import TieredPostingsIndex

    t_phase = time.perf_counter()
    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    cli = cli or [sys.executable, str(Path(__file__).resolve()), "--cli"]
    if model_config is not None:
        cli = cli + ["--model-config", json.dumps(
            {"vocab_size": model_config.vocab_size})]
    texts = hangul_texts(rng, max(n_text_docs, EXPORT_CHECK_DOCS), 60)
    queries = hangul_texts(rng, n_queries, 6)
    cli_texts = hangul_texts(rng, cli_docs, 40)

    # (a) the export
    exported, enc = export_check(torch, tok, final_dir, workdir / "hf",
                                 texts[:EXPORT_CHECK_DOCS], device, cli,
                                 model_config, timeout_s)
    doc_enc = SparseEncoderV33(enc.model, tok, doc_top_k=SERVE_DOC_TOP_K,
                               device=device)
    ids = [f"syn{i}" for i in range(len(syn_terms))] + [
        f"text{i}" for i in range(n_text_docs)]

    def build(cls, config, vecs):
        t0 = time.perf_counter()
        index = cls(V, device=device, **config)
        index.add_csr(ids[:len(syn_terms)], syn_terms, syn_vals)
        index.add_batch(ids[len(syn_terms):], vecs)
        index.build()
        return index, time.perf_counter() - t0

    # (b) tiered: the path's launches from the documents' encode on
    _reset_launch_counts()
    vecs = doc_enc.encode_documents(texts[:n_text_docs])
    indptr = np.concatenate([np.arange(len(syn_terms) + 1)
                             * syn_terms.shape[1],
                             len(syn_terms) * syn_terms.shape[1]
                             + np.cumsum([len(i) for i, _ in vecs])])
    exact = (sparse.csr_matrix(
        (np.concatenate([syn_vals.ravel()] + [v for _, v in vecs]),
         np.concatenate([syn_terms.ravel()] + [i for i, _ in vecs]),
         indptr), shape=(len(ids), V)), ids)
    index, build_s = build(TieredPostingsIndex, tiered, vecs)
    log(f"  tiered index: {len(index)} documents, cold P="
        f"{index.n_postings} + {index.n_hot} hot terms x "
        f"{index.hot_postings}, truncated {index.truncated_postings} "
        f"postings, scoring {index.resolved_scoring()}, "
        f"{index.memory_bytes() / 1e6:.0f} MB on the device, host build "
        f"{build_s:.1f} s")
    tiered_out, engine = serve_index(
        torch, "tiered", index, enc, tok, queries, texts[3], exact,
        workdir / "profile_tiered", device)
    tiered_out.update(build_s=build_s, memory_bytes=index.memory_bytes(),
                      n_hot=index.n_hot, launches=_launch_counts())
    del engine, index
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    # (c) cluster
    _reset_launch_counts()
    index, build_s = build(ClusterIndex, cluster, vecs)
    summary_bytes = index._built[0].numel() * index._built[0].element_size()
    log(f"  cluster index: {len(index)} documents in {index.n_clusters} "
        f"clusters of up to {index.cluster_size}, summary [{V}, "
        f"{index.n_clusters}] bf16 {summary_bytes / 1e9:.3f} GB, "
        f"{index.memory_bytes() / 1e6:.0f} MB on the device, host build "
        f"{build_s:.1f} s (clustering, summaries, postings side, doc-major "
        "block, upload)")
    cluster_out, engine = serve_index(
        torch, "cluster", index, enc, tok, queries, texts[3], exact,
        workdir / "profile_cluster", device)
    cluster_out.update(build_s=build_s, memory_bytes=index.memory_bytes(),
                       summary_bytes=summary_bytes,
                       n_clusters=index.n_clusters,
                       launches=_launch_counts())
    cluster_out["rescore"] = cluster_rescore_check(torch, engine, queries,
                                                   exact[0])
    del engine, index, doc_enc, enc
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    # (d) the server CLI from the export dir
    cli_out = server_cli_check(workdir, workdir / "hf", cli_texts, queries,
                               device, cli, timeout_s)
    result = dict(card=card, export=exported, tiered=tiered_out,
                  cluster=cluster_out, server_cli=cli_out,
                  seconds=time.perf_counter() - t_phase)
    log(f"  {card}: phase 9 in {result['seconds']:.1f} s; single-query "
        f"/search p50 / p99 ms: tiered {tiered_out['served']['p50_ms']:.2f}"
        f" / {tiered_out['served']['p99_ms']:.2f}, cluster "
        f"{cluster_out['served']['p50_ms']:.2f} / "
        f"{cluster_out['served']['p99_ms']:.2f}")
    shutil.rmtree(workdir, ignore_errors=True)
    return result


# ------------------------------------------------------------ phase 10
#: phase 10's mesh: eight shards, every one on the card
MESH_SHARDS = 8
#: (a) phase 3's two-phase postings configuration; (b) and (c) phase 9's
MESH_POSTINGS = dict(n_postings=256, query_top_t=64, rescore_candidates=1000)
#: (a)-(c) each merged score against the exact dot product of the query
#: and its document's stored weights (f64 on the host), relative to max(1,
#: the row's top score): f32 sums of at most T products in another order
MESH_EXACT_RTOL = 1e-5
#: phase 10's documents of the dense index (d), phase 3's count
MESH_DENSE_DOCS = 10_000


def mesh_fused_batch(torch, engine, queries, k: int) -> tuple:
    """One batched search through the engine's fused mesh route as
    ``search_batch`` runs it (the batch padded to its bucket), before any
    host filter: (merged scores [B, k'], global ids, the query vectors'
    weights [B, T], term ids) on the host."""
    from splade_tpu_torch.serving.engine import _bucket_batch

    B = len(queries)
    padded = list(queries) + [""] * (_bucket_batch(B, engine.batch_pad) - B)
    ids, mask = engine.encoder.tokenize(padded, engine.query_max_length)
    with torch.no_grad():
        vals, idxs, q_val, q_idx = engine._fused(ids, mask, k)
    return (vals.float().cpu().numpy()[:B], idxs.cpu().numpy()[:B],
            q_val.float().cpu().numpy()[:B], q_idx.cpu().numpy()[:B])


def merged_check(torch, name: str, engine, queries, k: int = 100,
                 require_positive: bool = False) -> dict:
    """Phase 10 holds (3) and (4) on the raw merged top-k of one batched
    search through the engine's mesh route (``mesh_fused_batch``): every id
    in [0, n); no document twice among a row's positive slots; each
    positive score the exact dot product of the query vector the route
    returned and that document's stored weights (its shard's doc-major row:
    int8 values times the row's scale), within MESH_EXACT_RTOL of max(1,
    the row's top score), so a merge that names other documents than its
    scores belong to fails. For the cluster index (``require_positive``),
    fetched again at the whole candidate pool (``max_results``: every
    shard's union, pads and zero scores included), every slot that is not
    positive must be the (0, 0) filler, so no pad document comes back."""
    index = engine.index
    n, per, vocab = index._base_n, index._shard_size, index.vocab_size

    def slots(k):
        vals, idxs, q_val, q_idx = mesh_fused_batch(torch, engine, queries, k)
        if (idxs < 0).any() or (idxs >= n).any():
            raise SystemExit(f"{name}: a merged id outside [0, {n})")
        pos = vals > 0
        for b in range(len(vals)):
            got = idxs[b][pos[b]].tolist()
            if len(got) != len(set(got)):
                raise SystemExit(f"{name}: a merged row holds a document "
                                 "twice")
        return vals, idxs, q_val, q_idx, pos

    stray = pool_other = None
    if require_positive:
        vals, idxs, _, _, pos = slots(index.max_results())
        pool_other = int((~pos).sum())
        stray = int(((~pos) & ((vals != 0) | (idxs != 0))).sum())
        if stray:
            raise SystemExit(f"{name}: {stray} merged slots neither positive "
                             "nor the (0, 0) filler: a pad document came "
                             "back")
    vals, idxs, q_val, q_idx, pos = slots(k)
    b_ix, s_ix = np.nonzero(pos)
    g = idxs[b_ix, s_ix]
    M = index._doc_major[0][0].shape[1]
    terms = np.empty((len(g), M), np.int64)
    weights = np.empty((len(g), M), np.float64)
    for d, (t, v, sc) in enumerate(index._doc_major):
        sel = g // per == d
        if sel.any():
            rows = torch.from_numpy(g[sel] % per).to(t.device)
            terms[sel] = t[rows].cpu().numpy()
            weights[sel] = (v[rows].cpu().numpy().astype(np.float64)
                            * sc[rows].cpu().numpy()[:, None])
    qd = np.zeros((len(vals), vocab + 1), np.float64)  # column V: pad terms
    np.add.at(qd, (np.arange(len(vals))[:, None], q_idx.astype(np.int64)),
              q_val.astype(np.float64))
    exact = (qd[b_ix[:, None], terms] * weights).sum(1)
    top = np.maximum(1.0, vals.max(1))
    err = float((np.abs(vals[b_ix, s_ix] - exact) / top[b_ix]).max(
        initial=0.0))
    out = dict(k=k, queries=len(vals), slots=int(pos.sum()),
               other_slots=int((~pos).sum()), max_rel_err=err,
               tol=MESH_EXACT_RTOL, pool_k=index.max_results()
               if require_positive else None, pool_other_slots=pool_other,
               stray_slots=stray)
    log(f"  {name}: the merged top-{k} of {len(vals)} queries over "
        f"{index.n_shards} shards: {out['slots']} positive slots, each the "
        f"exact dot product of its query and document within {err:.2e} of "
        f"max(1, top) (tol {MESH_EXACT_RTOL}); ids in [0, {n}), none twice; "
        f"{out['other_slots']} other slots" + (
            f"; at the whole pool (k={out['pool_k']}) {pool_other} slots not "
            "positive, every one the (0, 0) filler" if require_positive
            else ""))
    if not err <= MESH_EXACT_RTOL:
        raise SystemExit(f"{name}: a merged score is not its document's exact "
                         f"score ({err:.2e} of the top score)")
    return out


def shard_rescore_check(torch, name: str, engine, queries, module,
                        union: bool = False) -> dict:
    """Phase 10 hold (5): at one batched search (k=10), the rescore kernel
    on each shard's own candidates (``module.dispatch_rescore``
    intercepted: the search goes on with the kernel's scores) against
    ``rescore_match_plain`` on the same inputs (``union_rescore_stats``),
    within CLUSTER_RESCORE_TOL of max(1, top score); for the cluster union
    (``union``) also pad candidates scoring 0 and duplicates' copies bitwise
    equal, with pads and duplicates present. One rescore a shard. On the
    card, shard 0's kernel timed in a CUDA graph beside its bound and its
    plain version."""
    from splade_tpu_torch.ops import rescore_kernel

    dispatch, calls = module.dispatch_rescore, []

    def compared(d_terms, d_vals, d_scale, q_idx, q_val, cand, *rest, **kw):
        args = (d_terms, d_vals, d_scale, q_idx, q_val, cand)
        got = rescore_kernel.rescore_match(*args)
        calls.append((args, union_rescore_stats(
            torch, *args, got, rescore_kernel.rescore_match_plain(*args))))
        return got

    module.dispatch_rescore = compared
    try:
        engine.search_batch(queries, k=10)
    finally:
        module.dispatch_rescore = dispatch
    D = engine.index.n_shards
    if len(calls) != D:
        raise SystemExit(f"{name}: {len(calls)} rescores in one batch, "
                         f"expected one a shard ({D})")
    stats = [out for _, out in calls]
    out = dict(shards=D, shape=stats[0]["shape"],
               max_abs_err=max(x["max_abs_err"] for x in stats),
               tol=CLUSTER_RESCORE_TOL)
    if union:  # pads (the block's last row) and duplicates of the union
        out.update({key: sum(x[key] for x in stats) for key in (
            "pad_candidates", "duplicate_candidates", "pad_nonzero",
            "duplicates_unequal")})
    log(f"  {name}: the rescore kernel on each of the {D} shards' candidates "
        f"({out['shape']} a shard) == rescore_match_plain within "
        f"{out['max_abs_err']:.2e} of max(1, top score) (tol "
        f"{CLUSTER_RESCORE_TOL})" + (
            f"; {out['pad_candidates']} pad slots, {out['pad_nonzero']} "
            f"scoring other than 0; {out['duplicate_candidates']} duplicates,"
            f" {out['duplicates_unequal']} copies unequal" if union else ""))
    if not (out["max_abs_err"] <= CLUSTER_RESCORE_TOL and (not union or (
            out["pad_nonzero"] == 0 and out["duplicates_unequal"] == 0
            and out["pad_candidates"] > 0
            and out["duplicate_candidates"] > 0))):
        raise SystemExit(f"{name}: the rescore kernel differs from its plain "
                         "version on a shard, or a pad or duplicate candidate "
                         "scores wrong")
    if not calls[0][0][5].is_cuda:
        return dict(out, ms=None, plain_ms=None, bound_ms=None,
                    bound_by=None, library_ms=None)
    timed, _ = time_rescore(torch, *calls[0][0], plain_iters=3)
    log(f"  {name}: shard 0's rescore kernel {timed['ms']:.5f} ms in a CUDA "
        f"graph, plain match {timed['plain_ms']:.4f} ms, "
        f"{rescore_bound_text(timed)}")
    return dict(out, **timed)


def shard_device_check(torch, index, q_idx, q_val, k: int = 10) -> dict:
    """Each shard's search runs with its own device current: around one
    search of ``index`` (``_search_fn``, or ``score_topk`` of a dense mesh
    index), ``torch.cuda.device`` is wrapped with a recorder of the devices
    entered, and the rescore dispatch of each index module with a recorder
    of the device current at each rescore. Held: the devices entered, in
    order, are the mesh's CUDA devices, and the d-th rescore ran while
    shard d's device was current (None off CUDA). On one card every shard
    is on it; a mesh over several cards needs it, as the kernel library
    launches on the current device."""
    from splade_tpu_torch.ops import cluster_index, postings_index
    from splade_tpu_torch.ops import tiered_postings

    real, entered, current, rescored = torch.cuda.device, [], [None], []

    class Recorder:
        def __init__(self, device):
            self.device, self.inner = torch.device(device), real(device)

        def __enter__(self):
            entered.append(self.device)
            self.before, current[0] = current[0], self.device
            return self.inner.__enter__()

        def __exit__(self, *exc):
            current[0] = self.before
            return self.inner.__exit__(*exc)

    modules = (postings_index, tiered_postings, cluster_index)
    dispatches = [m.dispatch_rescore for m in modules]

    def recording(dispatch):
        def wrapped(*args, **kw):
            rescored.append(current[0])
            return dispatch(*args, **kw)
        return wrapped

    torch.cuda.device = Recorder
    for m, dispatch in zip(modules, dispatches):
        m.dispatch_rescore = recording(dispatch)
    try:
        with torch.no_grad():
            if hasattr(index, "score_topk"):  # the dense mesh index
                queries = torch.zeros((len(q_idx), index.vocab_size),
                                      device=q_idx.device)
                queries.scatter_add_(1, q_idx.long(), q_val.float())
                index.score_topk(queries, k)
            else:
                index._search_fn(q_idx, q_val, k)
    finally:
        torch.cuda.device = real
        for m, dispatch in zip(modules, dispatches):
            m.dispatch_rescore = dispatch
    cards = [d for d in index.mesh.devices if d.type == "cuda"]
    want = [d if d.type == "cuda" else None for d in index.mesh.devices]
    out = dict(shards=index.mesh.size, entered=[str(d) for d in entered],
               rescores=len(rescored))
    if entered != cards:
        raise SystemExit(f"shard devices: the search entered {entered}, "
                         f"expected each shard's card in order: {cards}")
    if rescored and rescored != want:
        raise SystemExit(f"shard devices: the rescores ran with {rescored} "
                         f"current, expected {want}")
    return out


def dense_mesh_check(torch, engine, model, tok, queries, device: str) -> dict:
    """Phase 10 (d) hold (2): the dense engine on the mesh against one
    device: a single-device ``ImpactIndex`` over the mesh index's own
    staged vectors (phase 3's documents, as its dense engine indexes them),
    served by an engine of the same model; batched searches at k=10 and
    100 (``compare_served``: SERVE_RTOL, tie order free)."""
    from splade_tpu_torch.ops.impact_index import ImpactIndex
    from splade_tpu_torch.serving.engine import ServingEngine

    index = engine.index
    single = ImpactIndex(index.vocab_size, quantize_int8=index.quantize_int8,
                         device=device)
    single.add_batch(index.doc_ids, index._docs)
    single.build()
    one = ServingEngine(model, tok, single, query_top_k=64, device=device)
    for k in (10, 100):
        compare_served(f"mesh dense k={k} (the mesh as served, one device as "
                       "plain)", engine.search_batch(queries, k=k),
                       one.search_batch(queries, k=k))
    return dict(docs=len(single), n_pad=index._n_pad,
                single_n_pad=single._n_pad)


def mesh_phase(torch, model, tok, syn_terms, syn_vals, text_docs,
               dense_docs, queries, workdir, card: str, devices,
               postings=MESH_POSTINGS, tiered=TIERED_CONFIG,
               cluster=CLUSTER_CONFIG) -> dict:
    """Phase 10: the mesh-sharded indexes (see the module's docstring) on
    ``make_mesh(devices=devices)``. ``model``: the seeded encoder of phase
    3; ``syn_terms``/``syn_vals``: phase 3's corpus; ``text_docs``,
    ``dense_docs``, ``queries``: phase 3's texts. The configs: the CPU
    rehearsal's tiny ones."""
    import shutil

    from scipy import sparse

    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.ops import cluster_index, postings_index
    from splade_tpu_torch.ops import tiered_postings
    from splade_tpu_torch.parallel import make_mesh
    from splade_tpu_torch.serving.engine import build_engine_from_docs

    t_phase = time.perf_counter()
    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    mesh = make_mesh(devices=devices)
    home = str(mesh.devices[0])
    on_card = mesh.devices[0].type == "cuda"
    enc = SparseEncoderV33(model, tok, device=home)

    def csr_of(doc_idx, doc_val):
        lens = [len(x) for x in doc_idx]
        return sparse.csr_matrix(
            (np.concatenate(doc_val), np.concatenate(doc_idx),
             np.concatenate([[0], np.cumsum(lens)])),
            shape=(len(doc_idx), V))

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else None

    def reset_peak():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    doc_enc = SparseEncoderV33(model, tok, doc_top_k=SERVE_DOC_TOP_K,
                               device=home)
    vecs = doc_enc.encode_documents(text_docs)
    n_syn = len(syn_terms)
    ids = [f"syn{i}" for i in range(n_syn)] + [
        f"text{i}" for i in range(len(text_docs))]
    exact = (csr_of(list(syn_terms) + [i for i, _ in vecs],
                    list(syn_vals) + [v for _, v in vecs]), ids)
    result = dict(card=card, shards=mesh.size, devices=[str(d) for d in
                                                        mesh.devices])
    for name, cls, config, module in (
            ("postings", postings_index.MeshShardedPostingsIndex, postings,
             postings_index),
            ("tiered", tiered_postings.MeshShardedTieredPostingsIndex, tiered,
             tiered_postings),
            ("cluster", cluster_index.MeshShardedClusterIndex, cluster,
             cluster_index)):
        t_index = time.perf_counter()
        reset_peak()
        index = cls(V, mesh, **config)
        index.add_csr(ids[:n_syn], syn_terms, syn_vals)
        index.add_batch(ids[n_syn:], vecs)
        index.build()
        build_s = time.perf_counter() - t_index
        log(f"  mesh {name}: {len(index)} documents over {index.n_shards} "
            f"shards of {index._shard_size}, {index.config_summary()}"
            + (f", {index.n_hot} hot rows" if name == "tiered" else "")
            + (f", {index.n_clusters} clusters" if name == "cluster" else "")
            + f", truncated {index.truncated_postings} postings, "
            f"{index.memory_bytes() / 1e6:.0f} MB, host build {build_s:.1f} s")
        _reset_launch_counts()
        out, engine = serve_index(
            torch, f"mesh {name}", index, enc, tok, queries, text_docs[3],
            exact, workdir / f"profile_{name}", home,
            rescores_per_batch=mesh.size)
        launches = _launch_counts()
        # the query vectors of the engine's route, for the device check
        _, _, q_val, q_idx = (torch.from_numpy(x).to(home) for x in
                              mesh_fused_batch(torch, engine, queries, 10))
        if on_card and not (launches["fused_splade_pool"] > 0
                            and launches["rescore_match"] > 0
                            and launches["rescore_match"] % mesh.size == 0):
            raise SystemExit(f"mesh {name}: launches {launches}, expected "
                             f"pool forwards and {mesh.size} rescores a "
                             "search")
        out.update(build_s=build_s, memory_bytes=index.memory_bytes(),
                   shard_size=index._shard_size, launches=launches,
                   peak_device_gb=peak_gb(),
                   merged=merged_check(torch, f"mesh {name}", engine,
                                       queries,
                                       require_positive=name == "cluster"),
                   rescore=shard_rescore_check(torch, f"mesh {name}", engine,
                                               queries, module,
                                               union=name == "cluster"),
                   devices=shard_device_check(torch, index, q_idx, q_val),
                   seconds=time.perf_counter() - t_index)
        if name == "tiered":
            out["n_hot"] = index.n_hot
        if name == "cluster":
            out["n_clusters"] = index.n_clusters
        log(f"  mesh {name}: peak device "
            + (f"{out['peak_device_gb']:.2f} GB" if on_card else "not measured")
            + f"; {out['seconds']:.1f} s")
        result[name] = out
        del engine, index
    del doc_enc

    # (d) the dense index through build_engine_from_docs(mesh=...)
    t_index = time.perf_counter()
    reset_peak()
    dense = build_engine_from_docs(
        model, tok, [(f"dense{i}", t) for i, t in enumerate(dense_docs)],
        int8=True, doc_top_k=256, index_type="dense", query_top_k=64,
        mesh=mesh)
    build_s = time.perf_counter() - t_index
    index = dense.index
    log(f"  mesh dense: {len(index)} documents int8, rows padded to "
        f"{index._n_pad} in {len(index._mat)} row shards, "
        f"{index.memory_bytes / 1e6:.0f} MB, built in {build_s:.1f} s "
        "(the documents' encode included)")
    exact_dense = (csr_of([i for i, _ in index._docs],
                          [v for _, v in index._docs]), list(index.doc_ids))
    _reset_launch_counts()
    out, engine = serve_index(torch, "mesh dense", index, enc, tok, queries,
                              dense_docs[5], exact_dense,
                              workdir / "profile_dense", home,
                              rescores_per_batch=0, engine=dense)
    out.update(build_s=build_s, memory_bytes=index.memory_bytes,
               launches=_launch_counts(), peak_device_gb=peak_gb(),
               against_one_device=dense_mesh_check(torch, engine, model, tok,
                                                   queries, home),
               devices=shard_device_check(torch, index, q_idx, q_val),
               seconds=time.perf_counter() - t_index)
    result["dense"] = out
    del engine, dense, index
    if on_card:
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  {card}: phase 10 in {result['seconds']:.1f} s; single-query "
        "/search p50 / p99 ms: " + ", ".join(
            f"{k} {result[k]['served']['p50_ms']:.2f} / "
            f"{result[k]['served']['p99_ms']:.2f}"
            for k in ("postings", "tiered", "cluster", "dense")))
    shutil.rmtree(workdir, ignore_errors=True)
    return result


# ------------------------------------------------------------ phase 11
#: phase 11's raw samples, and the registry key of each task type it writes and
#: the share of the base samples each gets (the registry has no "pair"
#: source: ko-triplet-v1's direct triplets stand beside the five others).
#: NLI takes two raw samples a premise (entailment, contradiction)
DATA_RAW = 10_000
DATA_SOURCES = {"korquad": 0.33, "koinstruct": 0.33, "ko-triplet-v1": 0.25,
                "kornli": 0.045, "korsts": 0.023, "nsmc": 0.022}
#: planted shares of the raw drop: exact and near duplicates of 1:1 rows,
#: English-only rows the cleaner drops
DATA_DUP_SHARE, DATA_JUNK_SHARE = 0.05, 0.02
#: the pipeline's shard size: a few shards from 10,000 raw samples
DATA_SHARD_SIZE = 2000
#: (c) the encoder miner: queries against positives, the reference's
#: rank window, the sampled queries held against the host, the tokens a
#: text (every positive fits)
DATA_MINE = dict(queries=1024, corpus=8192, check=64, rank_lo=10,
                 rank_hi=50, k=7, search_k=100, max_length=128)
#: a mined similarity against the host's f64 one at the same rank, on the
#: sparse pass; the dense pass holds to DATA_F32_FACTOR times the measured
#: f32 error of the product (a mined id and the host's at one rank each lie
#: within that error of the rank's f32 similarity)
DATA_SIM_TOL = 1e-5
DATA_F32_FACTOR = 2.0
#: (e) the information-gain filter at the module's stated workload, and
#: its entropies on the card against the CPU
DATA_IG = dict(n=5000, d=768)
DATA_IG_RTOL = 1e-9
#: (e) term pairs: planted to co-occur, apart (both terms in the corpus,
#: never planted together), out of the vocabulary; contexts a planted pair
DATA_TERMS = dict(planted=40, apart=20, oov=10, contexts=25)


def hangul_words(rng, stems, lo: int, hi: int) -> str:
    return " ".join(stems[j] for j in rng.integers(0, len(stems), int(
        rng.integers(lo, hi))))


def hangul_passage(rng, stems, sentences=(2, 5), words=(5, 12)) -> str:
    return ". ".join(hangul_words(rng, stems, *words) for _ in range(int(
        rng.integers(*sentences)))) + "."


def write_raw_drop(rng, root: Path, n_raw: int, terms: dict) -> dict:
    """Phase 11 (a): ``n_raw`` raw samples as local JSONL drops
    (``root/<registry key>.jsonl``, the layout ``load_dataset_samples``
    reads under ``$SPLADE_RAW_DATA``), Hangul from the port's
    ``random_hangul_stems``: a base of every task type, then exact
    duplicates and near duplicates (a sentence mark appended) of 1:1 rows
    (QA, dialog, triplets), then English-only rows. Term pairs: each
    planted pair's Korean and English terms as a sentence of their own in
    ``contexts`` QA passages, each apart pair's English term alone as a
    sentence in as many. -> what was written and planted."""
    from splade_tpu_torch.utils.synth import random_hangul_stems

    root.mkdir(parents=True, exist_ok=True)
    stems = random_hangul_stems(rng, 2000)
    n_dup = int(n_raw * DATA_DUP_SHARE)
    n_junk = int(n_raw * DATA_JUNK_SHARE)
    n_base = n_raw - 2 * n_dup - n_junk
    counts = {k: int(n_base * share) for k, share in DATA_SOURCES.items()}
    counts["kornli"] -= counts["kornli"] % 2
    counts["korquad"] += n_base - sum(counts.values())
    ascii_word = lambda: "".join(chr(97 + int(c)) for c in rng.integers(
        0, 26, int(rng.integers(5, 9))))
    n_pairs = terms["planted"] + terms["apart"] + terms["oov"]
    ko = [stems[int(i)] for i in rng.choice(len(stems), n_pairs,
                                            replace=False)]
    ko[-terms["oov"]:] = random_hangul_stems(rng, terms["oov"],
                                             seed_words=tuple(stems))[-terms[
                                                 "oov"]:]
    en = []
    while len(en) < n_pairs:
        w = ascii_word()
        if w not in en:
            en.append(w)
    pairs = list(zip(ko, en))
    rows = {k: [] for k in DATA_SOURCES}
    ctx = [hangul_passage(rng, stems) for _ in range(counts["korquad"])]
    slots = iter(rng.permutation(len(ctx)).tolist())
    # a planted pair is a sentence of its own two terms; an apart pair's
    # English term a sentence of its own, so it co-occurs with nothing
    for a, b in pairs[:terms["planted"]]:
        for _ in range(terms["contexts"]):
            i = next(slots)
            ctx[i] = f"{a} {b}. {ctx[i]}"
    for _, b in pairs[terms["planted"]:terms["planted"] + terms["apart"]]:
        for _ in range(terms["contexts"]):
            i = next(slots)
            ctx[i] = f"{b}. {ctx[i]}"
    rows["korquad"] = [{"question": hangul_words(rng, stems, 4, 12) + "?",
                        "context": c} for c in ctx]
    rows["koinstruct"] = [{"instruction": hangul_words(rng, stems, 4, 12),
                           "output": hangul_passage(rng, stems)}
                          for _ in range(counts["koinstruct"])]
    rows["ko-triplet-v1"] = [{"query": hangul_words(rng, stems, 4, 12),
                              "document": hangul_passage(rng, stems),
                              "hard_negative": hangul_passage(rng, stems)}
                             for _ in range(counts["ko-triplet-v1"])]
    for _ in range(counts["kornli"] // 2):
        premise = hangul_passage(rng, stems, (1, 3))
        rows["kornli"] += [
            {"premise": premise, "hypothesis": hangul_words(rng, stems, 4, 12),
             "label": label} for label in (0, 2)]
    rows["korsts"] = [{"sentence1": hangul_words(rng, stems, 4, 12),
                       "sentence2": hangul_words(rng, stems, 4, 12),
                       "score": round(float(rng.uniform(0, 5)), 2)}
                      for _ in range(counts["korsts"])]
    rows["nsmc"] = [{"document": hangul_words(rng, stems, 4, 14),
                     "label": int(rng.integers(2))}
                    for _ in range(counts["nsmc"])]
    # planted duplicates of the 1:1 sources' rows (their keys: the fields
    # the converters make query and positive of)
    one_to_one = {"korquad": ("question", "context"),
                  "koinstruct": ("instruction", "output"),
                  "ko-triplet-v1": ("query", "document")}
    picks = [(k, i) for k in one_to_one for i in range(len(rows[k]))]
    chosen = rng.choice(len(picks), 2 * n_dup, replace=False)
    exact_keys = []
    for n, c in enumerate(chosen):
        k, i = picks[int(c)]
        row = dict(rows[k][i])
        qf, pf = one_to_one[k]
        if n < n_dup:
            exact_keys.append(f"{row[qf]}\t{row[pf]}")
        else:
            row[qf] += " !"
        rows[k].append(row)
    rows["korquad"] += [{"question": f"{ascii_word()} {ascii_word()} ?",
                         "context": " ".join(ascii_word() for _ in range(12))}
                        for _ in range(n_junk)]
    for k, rs in rows.items():
        order = rng.permutation(len(rs))
        with open(root / f"{k}.jsonl", "w", encoding="utf-8") as f:
            for i in order:
                f.write(json.dumps(rs[int(i)], ensure_ascii=False) + "\n")
    written = {k: len(v) for k, v in rows.items()}
    assert sum(written.values()) == n_raw, written
    return dict(written=written, exact_keys=exact_keys, near=n_dup,
                junk=n_junk, pairs=pairs)


def write_term_cache(root: Path, pairs, terms: dict) -> dict:
    """Phase 11 (e): the term pairs as a local ``$SPLADE_TERM_DATA`` cache
    in the three layouts the port's collectors read: the planted and apart
    pairs as a MUSE dictionary (Korean first), the OOV pairs as Wikidata
    SPARQL bindings and as Wikipedia langlinks payloads (half each)."""
    (root / "muse").mkdir(parents=True, exist_ok=True)
    known = pairs[:terms["planted"] + terms["apart"]]
    oov = pairs[len(known):]
    (root / "muse" / "ko-en.txt").write_text(
        "".join(f"{a} {b}\n" for a, b in known), encoding="utf-8")
    half = len(oov) // 2
    (root / "wikidata.json").write_text(json.dumps({"results": {"bindings": [
        {"koLabel": {"value": a}, "enLabel": {"value": b.capitalize()}}
        for a, b in oov[:half]]}}, ensure_ascii=False), encoding="utf-8")
    (root / "wikipedia_langlinks.jsonl").write_text("".join(
        json.dumps({"query": {"pages": {str(i): {
            "title": a, "langlinks": [{"lang": "en", "*": b}]}}}},
            ensure_ascii=False) + "\n"
        for i, (a, b) in enumerate(oov[half:])), encoding="utf-8")
    return dict(muse=len(known), wikidata=half, wikipedia=len(oov) - half)


def timed_stages(pipe, names=("collect", "convert", "clean", "dedup", "mine",
                              "shard")) -> dict:
    """Wrap the pipeline instance's stage methods so that ``run()`` records
    each stage's seconds (the pipeline itself times only the whole)."""
    seconds = {}
    for name in names:
        fn = getattr(pipe, name)

        def stage(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                seconds[_name] = time.perf_counter() - t0

        setattr(pipe, name, stage)
    return seconds


def check_pipeline_output(out_dir: Path, meta: dict, tok, planted) -> tuple:
    """Phase 11 (b)'s holds on what the pipeline wrote: every row of every
    shard and of val.jsonl parses through the port's load_training_data
    (none skipped) and collates through TripletCollator; no row's negative
    equals its positive; no (query, positive) key twice, so every planted
    exact duplicate is gone. -> (the counts, the rows: train shards, then
    val.jsonl)."""
    from splade_tpu_torch.data import TripletCollator, load_training_data

    files = [str(out_dir / s) for s in meta["shards"]] + [
        str(out_dir / "val.jsonl")]
    lines = sum(1 for f in files for line in open(f, encoding="utf-8")
                if line.strip())
    data = load_training_data(files)
    rows = list(data)
    if not (len(rows) == lines == meta["train"] + meta["val"]
            == meta["total"]):
        raise SystemExit(f"pipeline: {len(rows)} rows parsed of {lines} "
                         f"lines; metadata says {meta['train']} + "
                         f"{meta['val']} = {meta['total']}")
    collator = TripletCollator(tok, query_max_length=64, doc_max_length=256)
    batches = 0
    for i in range(0, len(rows), 512):
        enc = collator(rows[i:i + 512])
        n = len(rows[i:i + 512])
        if (enc["query_input_ids"].shape != (n, 64)
                or enc["positive_input_ids"].shape != (n, 256)
                or enc["negative_input_ids"].shape != (n, 256)):
            raise SystemExit("pipeline: a batch collated to other shapes")
        batches += 1
    own = [r for r in rows if r.get("negative") == r["positive"]
           or r["positive"] in (r.get("negatives") or [])]
    keys = [f"{r['query']}\t{r['positive']}" for r in rows]
    twice = len(keys) - len(set(keys))
    left = sum(1 for k in set(planted) if keys.count(k) != 1)
    with_negative = sum(1 for r in rows if r.get("negative")
                        or r.get("negatives"))
    out = dict(rows=len(rows), batches=batches, negative_is_positive=len(own),
               keys_twice=twice, planted_exact=len(planted),
               planted_exact_not_once=left, with_negative=with_negative)
    log(f"  (b) held: {len(rows)} rows parse and collate ({batches} "
        f"batches); a negative equal to its positive: {len(own)}; a "
        f"(query, positive) twice: {twice}; planted exact duplicates not "
        f"left exactly once: {left} of {len(planted)}")
    if own or twice or left or with_negative != meta["with_negative"]:
        raise SystemExit(f"pipeline: the written rows fail a hold: {out}")
    return out, rows


class MiningAdapter:
    """Phase 11 (c)'s encoder for EncoderHardNegativeMiner: texts through
    the stand-in tokenizer at ``max_length`` positions and
    ``SparseEncoderV33.encode_tensor`` (the pool forward kernel) to [N, V]
    f32 on the encoder's device. Keeps each call's rows, in order, for the
    host's recomputation, and the seconds it spent."""

    def __init__(self, torch, enc, max_length: int):
        self.torch, self.enc, self.max_length = torch, enc, max_length
        self.rows, self.seconds, self.texts = [], 0.0, 0

    def encode(self, texts):
        torch = self.torch
        t0 = time.perf_counter()
        out = self.enc.encode_tensor(*self.enc.tokenize(texts,
                                                        self.max_length))
        if out.is_cuda:
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.texts += len(texts)
        self.rows.append(out)
        return out

    def take(self, n: int):
        """The next ``n`` rows recorded, concatenated (f32, host)."""
        got, have = [], 0
        while have < n:
            got.append(self.rows.pop(0))
            have += len(got[-1])
        if have != n:
            raise SystemExit("mining: the encoder's batches do not split "
                             "at the call's texts")
        return self.torch.cat(got).float().cpu().numpy()


def unit_rows64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return x / norms


def f32_error(torch, q: np.ndarray, c: np.ndarray, check, sims64,
              device: str) -> dict:
    """Phase 11 (c): the largest |f32 - f64| of the sampled queries'
    similarities (``sims64``, rows ``check`` of ``q`` against ``c``): a
    numpy f32 product on the host, and the miner's own product on its
    device (rows normalised as the miner normalises them, the same
    ``QUERY_CHUNK`` queries a product, so the same f32 sums the miner
    ranked)."""
    from splade_tpu_torch.preprocessing.miners import QUERY_CHUNK

    def unit32(x):
        norms = np.linalg.norm(x, axis=1, keepdims=True)
        norms[norms == 0] = 1.0
        return x / norms

    host = float(np.abs(unit32(q[check]) @ unit32(c).T - sims64).max())

    def unit(x):
        x = torch.as_tensor(x, device=device)
        norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        return x / torch.where(norms == 0, torch.ones_like(norms), norms)

    qd, cd = unit(q), unit(c)
    got = torch.cat([(qd[i:i + QUERY_CHUNK] @ cd.T) for i in range(
        0, len(qd), QUERY_CHUNK)])[torch.as_tensor(check, device=device)]
    dev = float(np.abs(got.double().cpu().numpy() - sims64).max())
    return dict(host=host, device=dev)


def check_window(mined, sims, corpus, positives, rank_lo: int, rank_hi: int,
                 k: int, search_k: int, tol: float = DATA_SIM_TOL) -> dict:
    """Phase 11 (c), rank window: for each sampled query (its row of
    ``sims``, the host's f64 similarities to every corpus text), the host
    takes the reference's selection (top ``search_k`` in order, ranks
    [rank_lo, rank_hi), the positive's text skipped, the first k); every
    mined id's host similarity must equal the host selection's at the same
    rank within ``tol`` (ties near in f32 may swap ids), and no mined id
    may be the positive's text or repeat. Also returns how far the host's
    similarities move when the window starts one rank later (the largest
    such move the hold would see)."""
    worst, shifted, n = 0.0, 0.0, 0

    def select(order, pos, lo, hi):
        return [int(j) for j in order[lo:hi] if corpus[j] != pos][:k]

    for got, row, pos in zip(mined, sims, positives):
        order = np.argsort(-row, kind="stable")[:min(search_k + 1, len(row))]
        want = select(order[:search_k], pos, rank_lo, rank_hi)
        later = select(order, pos, rank_lo + 1, rank_hi + 1)
        if len(got) != len(want) or len(set(got)) != len(got):
            raise SystemExit(f"mining: the rank window gave {len(got)} ids "
                             f"(distinct {len(set(got))}), the host "
                             f"{len(want)}")
        if any(corpus[j] == pos for j in got):
            raise SystemExit("mining: a mined negative is the positive")
        if got:
            worst = max(worst, float(np.abs(row[got] - row[want]).max()))
        m = min(len(want), len(later))
        if m:
            shifted = max(shifted, float(np.abs(row[want[:m]]
                                                - row[later[:m]]).max()))
        n += len(got)
    if worst > tol:
        raise SystemExit(f"mining: a mined similarity differs from the "
                         f"host's at its rank by {worst:.3e} > {tol:.3e}")
    return dict(ids=n, max_sim_diff=worst, tol=tol, one_rank_later=shifted)


def check_band(mined, sims, lo: float, hi: float, k: int,
               tol: float = DATA_SIM_TOL) -> dict:
    """Phase 11 (c), band: every mined id's host similarity lies in [lo,
    hi] within ``tol``, each list runs in descending host similarity
    within ``tol``, and holds min(in band, k) ids, where an id whose host
    similarity lies within ``tol`` of lo or hi may count as in the band
    or not."""
    n = 0
    for got, row in zip(mined, sims):
        s = row[got]
        sure = int(((row >= lo + tol) & (row <= hi - tol)).sum())
        maybe = int(((row >= lo - tol) & (row <= hi + tol)).sum())
        if (np.any(s < lo - tol) or np.any(s > hi + tol)
                or np.any(np.diff(s) > tol)
                or len(set(got)) != len(got)
                or not min(sure, k) <= len(got) <= min(maybe, k)):
            raise SystemExit(f"mining: band ids {got} with host similarities"
                             f" {s.tolist()} against [{lo}, {hi}] ({sure} to "
                             f"{maybe} in the band, k {k})")
        n += len(got)
    return dict(ids=n, lo=lo, hi=hi, tol=tol)


def mining_pass(torch, miner, adapter, queries, corpus, positives, check,
                mine: dict, sync, tol=None) -> dict:
    """Phase 11 (c), one pass of ``EncoderHardNegativeMiner``: the rank
    window, then the band (the 50th-90th percentiles of the sampled
    queries' positive host similarities) over the same texts, held on the
    sampled queries ``check`` against the host's f64 similarities from the
    embeddings the kernel produced. ``tol`` None: ``DATA_F32_FACTOR``
    times the larger f32 error of ``f32_error`` (a mined id and the host's
    at one rank each lie within that error of the rank's f32 value)."""
    nq, nc = len(queries), len(corpus)
    encode0 = adapter.seconds
    t0 = time.perf_counter()
    window = miner.mine_rank_window(
        queries, corpus, positives, rank_lo=mine["rank_lo"],
        rank_hi=mine["rank_hi"], k=mine["k"], search_k=mine["search_k"])
    sync()
    window_s = time.perf_counter() - t0
    q_raw, c_raw = adapter.take(nq), adapter.take(nc)
    nonzeros = dict(queries=float((q_raw > 0).sum(1).mean()),
                    positives=float((c_raw > 0).sum(1).mean()))
    t0 = time.perf_counter()
    sims = unit_rows64(q_raw[check]) @ unit_rows64(c_raw).T
    host_s = time.perf_counter() - t0
    err = f32_error(torch, q_raw, c_raw, check, sims, str(miner.device))
    del q_raw, c_raw
    if tol is None:
        tol = DATA_F32_FACTOR * max(err.values())
    held_window = check_window(
        [window[i] for i in check], sims, corpus,
        [positives[i] for i in check], mine["rank_lo"], mine["rank_hi"],
        mine["k"], mine["search_k"], tol)
    lo, hi = (float(x) for x in np.percentile(sims[sims > 0], [50.0, 90.0]))
    t0 = time.perf_counter()
    band = miner.mine_band(queries, corpus, min_score=lo, max_score=hi,
                           k=mine["k"])
    sync()
    band_s = time.perf_counter() - t0
    adapter.rows.clear()
    held_band = check_band([band[i] for i in check], sims, lo, hi, mine["k"],
                           tol)
    encode_s = adapter.seconds - encode0
    top = np.sort(sims, axis=1)[:, ::-1][:, :mine["search_k"]]
    return dict(nonzeros=nonzeros, encode_s=encode_s,
                search_s=window_s + band_s - encode_s, window_s=window_s,
                band_s=band_s, host_s=host_s, f32_err=err, tol=tol,
                window=held_window, band=held_band,
                median=float(np.median(sims)),
                zero=float((sims == 0).mean()),
                top=(float(top[:, -1].mean()), float(top[:, 0].mean())))


def independent_idf(texts, tok, vocab: int, mode: str) -> tuple:
    """Phase 11 (d)'s reference: the document frequencies from a numpy
    ``unique`` of each document's ids, then the reference's smoothing."""
    df = np.zeros(vocab, np.int64)
    for text in texts:
        ids = np.asarray(tok(text, add_special_tokens=False)["input_ids"],
                         np.int64)
        ids = np.unique(ids)
        df += np.bincount(ids[(ids >= 0) & (ids < vocab)], minlength=vocab)
    n = len(texts)
    if mode == "bm25":
        idf = np.log(1.0 + (n - df + 0.5) / (df + 0.5))
    else:
        idf = np.log(n / (df + 1.0))
    return idf.astype(np.float32), n, int((df > 0).sum())


def check_idf(got, meta, texts, tok, vocab: int, mode: str) -> dict:
    want, n, nonzero = independent_idf(texts, tok, vocab, mode)
    if not (got.dtype == want.dtype and np.array_equal(got, want)
            and meta["num_docs"] == n and meta["df_nonzero"] == nonzero
            and meta["mode"] == mode and meta["vocab_size"] == vocab):
        diff = int((got != want).sum()) if got.shape == want.shape else -1
        raise SystemExit(f"idf ({mode}): {diff} ids differ from the "
                         f"independent count ({meta} vs {n} documents, "
                         f"{nonzero} terms)")
    return dict(num_docs=n, df_nonzero=nonzero)


def ig_pairs(rng, n: int, d: int, rank: int = 8, group: int = 4,
             spread: float = 0.1):
    """Phase 11 (e)'s pairs: seeded Gaussian embeddings in groups of
    ``group`` (synonym groups) around N(0, 3^2) centres of a ``rank``-dim
    subspace of R^d. The first half's targets copy their sources up to
    N(0, 0.01^2) in all d dims (trivial); the second half's are drawn the
    same way, independently of their sources, and shuffled. The estimator
    predicts a target from the targets of its source's nearest sources, so
    a trivial pair is visible as one where its group-mates are trivial
    too."""
    basis = np.linalg.qr(rng.normal(size=(d, rank)))[0].T

    def draw(m):
        centres = rng.normal(scale=3.0, size=(m // group, rank))
        return (np.repeat(centres, group, axis=0)
                + rng.normal(scale=spread, size=(m, rank))) @ basis

    src = draw(n)
    half = n // 2
    tgt = src + rng.normal(scale=0.01, size=(n, d))
    tgt[half:] = draw(n - half)[rng.permutation(n - half)]
    return src, tgt


def check_ig(res_dev, res_cpu, ent_dev, ent_cpu, trivial: int,
             rtol: float = DATA_IG_RTOL) -> dict:
    """Phase 11 (e): the entropies on the device within ``rtol`` of the
    same functions on the CPU; the gains too (of the largest); the same
    keep/drop decisions but for pairs within ``rtol`` of the threshold; the
    first ``trivial`` pairs (the planted trivial ones) all dropped and the
    others kept."""
    ent_err = max(abs(a - b) / max(abs(b), 1e-300)
                  for a, b in zip(ent_dev, ent_cpu))
    g_dev = np.asarray([r.information_gain for r in res_dev])
    g_cpu = np.asarray([r.information_gain for r in res_cpu])
    scale = float(np.abs(g_cpu).max())
    gain_err = float(np.abs(g_dev - g_cpu).max()) / scale
    thr = float(np.percentile(g_cpu, 50.0))
    near = np.abs(g_cpu - thr) <= rtol * scale
    differ = sum(1 for a, b, x in zip(res_dev, res_cpu, near)
                 if a.keep != b.keep and not x)
    keep = [r.keep for r in res_dev]
    trivial_kept = sum(keep[:trivial])
    other_dropped = sum(not x for x in keep[trivial:])
    out = dict(entropy_rel_err=ent_err, gain_rel_err=gain_err,
               decisions_differ=differ, near_threshold=int(near.sum()),
               trivial_kept=trivial_kept, independent_dropped=other_dropped)
    if (ent_err > rtol or gain_err > rtol or differ or trivial_kept
            or other_dropped):
        raise SystemExit(f"information gain: {out}")
    return out


def data_phase(torch, model, tok, rng, workdir, card: str,
               device: str = "cuda", n_raw: int = DATA_RAW, mine=None,
               ig=None, terms=None, sparse_nnz=(BENCH_DOC_NNZ,
                                                BENCH_QUERY_NNZ),
               recipe=None, model_config=None,
               model_over=None, train_steps: int = 3,
               timeout_s: float = DP_TIMEOUT_S) -> dict:
    """Phase 11: the offline data tier from raw drops to V33 training (see
    the module's docstring). ``model``: phase 3's seeded encoder (bf16,
    the pool kernel), its decoder bias shifted by ``sparsify`` for (c) and
    put back; the sizes, nonzeros, recipe and model config: the CPU
    rehearsal's smaller ones."""
    import shutil

    from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
    from splade_tpu_torch.information_gain import (InformationGainFilter,
                                                   _pairwise_sq_dists,
                                                   kl_entropy)
    from splade_tpu_torch.pmi import (CooccurrenceBuilder, PMICalculator,
                                      PPMICalculator, SynonymValidator)
    from splade_tpu_torch.pmi.cooccurrence import (default_tokenizer,
                                                   split_sentences)
    from splade_tpu_torch.preprocessing import (PipelineConfig,
                                                PreprocessingPipeline)
    from splade_tpu_torch.preprocessing import term_pairs
    from splade_tpu_torch.preprocessing.miners import (
        EncoderHardNegativeMiner, TfidfHardNegativeMiner)
    from splade_tpu_torch.utils.idf import compute_idf, load_idf, triplet_texts

    mine = mine or DATA_MINE
    ig = ig or DATA_IG
    terms = terms or DATA_TERMS
    recipe = recipe or v33_recipe()
    if model_config is None:
        from splade_tpu_torch.models.modernbert import ModernBertConfig

        model_config = ModernBertConfig(remat=True)
    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    result = {}

    # (a) the raw drop
    t0 = time.perf_counter()
    drop = write_raw_drop(rng, workdir / "raw", n_raw, terms)
    log(f"  (a) {n_raw} raw samples written as local drops "
        f"{drop['written']} with {len(drop['exact_keys'])} exact and "
        f"{drop['near']} near duplicates and {drop['junk']} English-only "
        f"rows planted, in {time.perf_counter() - t0:.1f} s (cut from the "
        "reference's 4.84M triplets out of nine datasets, which a smoke "
        "run has no time for)")

    # (b) the pipeline
    cfg = PipelineConfig(output_dir=str(workdir / "processed"),
                         datasets=sorted(DATA_SOURCES),
                         shard_size=DATA_SHARD_SIZE)
    pipe = PreprocessingPipeline(cfg, miner=TfidfHardNegativeMiner(top_k=1))
    stages = timed_stages(pipe)
    with mock.patch.dict(os.environ, SPLADE_RAW_DATA=str(workdir / "raw")):
        meta = pipe.run()
    keys = ("raw_samples", "converted", "after_clean", "after_dedup",
            "with_negative", "train", "val")
    log(f"  (b) pipeline: " + ", ".join(f"{k} {meta[k]}" for k in keys)
        + f", {len(meta['shards'])} shards; seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
        + f" (run {meta['elapsed_sec']} s)")
    out_dir = workdir / "processed"
    held, rows = check_pipeline_output(out_dir, meta, tok,
                                       drop["exact_keys"])
    if meta["raw_samples"] != n_raw:
        raise SystemExit(f"pipeline: collected {meta['raw_samples']} of "
                         f"{n_raw} raw samples")
    result["pipeline"] = dict(
        {k: meta[k] for k in keys}, shards=len(meta["shards"]),
        stage_s=stages, elapsed_s=meta["elapsed_sec"],
        near_dropped=meta["after_clean"] - meta["after_dedup"]
        - len(drop["exact_keys"]), held=held)

    # (c) encoder mining through the pool forward kernel, twice: on vectors
    # as sparse as a trained model's (phase 8's decoder-bias shift), where
    # similarities spread and the hold is DATA_SIM_TOL, and on the dense
    # vectors of random weights, crowded as a dense teacher's, where two
    # ranks lie within the f32 error and the hold is that error's bound
    nq, nc = mine["queries"], mine["corpus"]
    if len(rows) < nc:
        raise SystemExit(f"mining: {len(rows)} rows, fewer than {nc}")
    corpus = [r["positive"] for r in rows[:nc]]
    queries = [r["query"] for r in rows[:nq]]
    positives = corpus[:nq]
    check = rng.choice(nq, mine["check"], replace=False)
    bias = model.mlm.decoder.bias.detach().clone()
    enc = SparseEncoderV33(model, tok, device=device)
    adapter = MiningAdapter(torch, enc, mine["max_length"])
    miner = EncoderHardNegativeMiner(adapter, device=device)
    passes = {}
    try:
        shift, _ = sparsify(torch, model, tok, corpus[:64], queries[:64],
                            device, *sparse_nnz)
        # the pool forward against its plain version at mining's shape
        encode_diff = compare_doc_encode(torch, enc, model, corpus[:512],
                                         mine["max_length"],
                                         miner.batch_size, "mining")
        _reset_launch_counts()
        passes["sparse"] = mining_pass(torch, miner, adapter, queries,
                                       corpus, positives, check, mine, sync,
                                       DATA_SIM_TOL)
    finally:
        with torch.no_grad():
            model.mlm.decoder.bias.copy_(bias)
    passes["dense"] = mining_pass(torch, miner, adapter, queries, corpus,
                                  positives, check, mine, sync)
    launches = _launch_counts()["fused_splade_pool"]
    batches = 4 * (-(-nq // miner.batch_size) + -(-nc // miner.batch_size))
    want = batches if on_card else 0
    for kind, p in passes.items():
        log(f"  (c) encoder mining, {kind} vectors"
            + (f" (decoder bias -{shift:.4f})" if kind == "sparse" else "")
            + f", {nq} queries against {nc} positives at S = "
            f"{mine['max_length']}: {p['nonzeros']['positives']:.1f} / "
            f"{p['nonzeros']['queries']:.1f} nonzeros a positive / query; "
            f"sampled similarities: median {p['median']:.4f}, zero "
            f"{p['zero']:.1%}, top {mine['search_k']} from {p['top'][0]:.4f}"
            f" to {p['top'][1]:.4f} (means) (rank window "
            f"[{mine['rank_lo']}, {mine['rank_hi']}) k {mine['k']} of the "
            f"top {mine['search_k']}; band [{p['band']['lo']:.6f}, "
            f"{p['band']['hi']:.6f}], the 50th-90th percentiles of the "
            f"sampled queries' positive similarities): encode "
            f"{p['encode_s']:.2f} s ({2 * (nq + nc) / p['encode_s']:.1f} "
            f"texts/s), search {p['search_s']:.2f} s, host f64 "
            f"recomputation {p['host_s']:.2f} s; f32 error of the product "
            f"{p['f32_err']['device']:.3e} on the device, "
            f"{p['f32_err']['host']:.3e} on the host; held on "
            f"{mine['check']} sampled queries: window similarities within "
            f"{p['window']['max_sim_diff']:.3e} of the host's (tol "
            f"{p['tol']:.3e}; a window one rank later would differ by up to "
            f"{p['window']['one_rank_later']:.3e}), no positive, band ids "
            "in the band")
    log(f"  (c) pool forward launches {launches} (expected {want}, one an "
        f"encode batch)")
    if launches != want:
        raise SystemExit(f"mining: {launches} pool forward launches, "
                         f"expected {want}")
    encode_s = sum(p["encode_s"] for p in passes.values())
    result["mining"] = dict(queries=nq, corpus=nc, texts=adapter.texts,
                            bias_shift=shift, encode_diff=encode_diff,
                            encode_s=encode_s,
                            texts_per_s=adapter.texts / encode_s,
                            launches=launches, corpus_gb=nc * V * 4 / 1e9,
                            **passes)
    del miner, adapter, enc
    if on_card:
        torch.cuda.empty_cache()

    # (d) corpus IDF, both modes, and the tool's file layout
    t0 = time.perf_counter()
    shards = [str(out_dir / s) for s in meta["shards"]]
    texts = triplet_texts(shards)
    result["idf"] = {}
    for mode in ("bm25", "standard"):
        idf, idf_meta = compute_idf(texts, tok, V, mode)
        held_idf = check_idf(idf, idf_meta, texts, tok, V, mode)
        prefix = str(workdir / f"idf_{mode}")
        idf.astype("<f4").tofile(prefix + ".bin")
        Path(prefix + ".json").write_text(json.dumps(idf_meta))
        back, back_meta = load_idf(prefix)
        if not (np.array_equal(back, idf) and back_meta == idf_meta):
            raise SystemExit(f"idf ({mode}): the .bin/.json round trip "
                             "differs")
        result["idf"][mode] = held_idf
    idf_s = time.perf_counter() - t0
    log(f"  (d) IDF over {len(texts)} texts of the train shards, bm25 and "
        f"standard: bitwise the independent count and through "
        f"<prefix>.bin/.json and load_idf ({held_idf['df_nonzero']} terms "
        f"seen), {idf_s:.2f} s")
    result["idf"]["seconds"] = idf_s

    # (e) PMI over the pipeline's positives, term pairs from a local cache
    t0 = time.perf_counter()
    docs = [r["positive"] for r in rows]
    cooc = CooccurrenceBuilder(window="sentence", min_count=2).build(docs)
    calc = PMICalculator(cooc, smoothing=1.0 / len(cooc.vocab))
    pmi_m, ppmi_m = calc.pmi_matrix(), PPMICalculator(
        cooc, smoothing=1.0 / len(cooc.vocab)).pmi_matrix()
    cache = write_term_cache(workdir / "terms", drop["pairs"], terms)

    def refuse(*a, **k):
        raise SystemExit("term pairs: a collector reached for the network "
                         "with a local cache")

    with mock.patch.dict(os.environ,
                         SPLADE_TERM_DATA=str(workdir / "terms")):
        collected = (term_pairs.collect_muse(refuse)
                     + term_pairs.collect_wikidata(refuse)
                     + term_pairs.collect_wikipedia(refuse))
    unique, rejected = term_pairs.filter_and_deduplicate(collected)
    validator = SynonymValidator(calc, threshold=0.0)
    results = validator.validate([(p["ko"], p["en"]) for p in unique])
    n_plant, n_apart = terms["planted"], terms["apart"]
    by_pair = {(r.source, r.target): r for r in results}
    planted = [by_pair[p] for p in drop["pairs"][:n_plant]]
    apart = [by_pair[p] for p in drop["pairs"][n_plant:n_plant + n_apart]]
    oov = [by_pair[p] for p in drop["pairs"][n_plant + n_apart:]]
    # the co-occurrence counts of the term pairs against a direct scan
    windows = [set(default_tokenizer(s)) for d in docs
               for s in split_sentences(d)]
    counts_ok = all(
        cooc.count(a, b) == sum(1 for w in windows if a in w and b in w)
        for a, b in drop["pairs"][:n_plant + n_apart]
        if a in cooc.vocab and b in cooc.vocab)
    pmi_s = time.perf_counter() - t0
    report = validator.report(results, str(workdir / "synonyms.md"))
    log(f"  (e) PMI: vocabulary {len(cooc.vocab)}, {cooc.total_windows} "
        f"windows, {pmi_m.nnz} observed pairs (PPMI "
        f"{int((ppmi_m.data > 0).sum())} positive), smoothing 1/V; term pairs from the local cache "
        f"{cache} -> {len(collected)} collected, {len(unique)} after the "
        f"filter; valid: planted {sum(r.valid for r in planted)} of "
        f"{n_plant}, apart {sum(r.valid for r in apart)} of {n_apart}, OOV "
        f"{sum(r.valid for r in oov)} of {len(oov)}; counts against a "
        f"direct scan equal: {counts_ok}; {pmi_s:.2f} s")
    if not (len(unique) == len(drop["pairs"]) and counts_ok
            and all(r.valid for r in planted)
            and not any(r.valid for r in apart)
            and all(r.reason == "oov_rejected" for r in oov)
            and "Synonym validation" in report):
        raise SystemExit(f"PMI: the term pairs fail a hold ({rejected})")
    result["pmi"] = dict(vocab=len(cooc.vocab), windows=cooc.total_windows,
                         pairs=int(pmi_m.nnz), collected=len(collected),
                         unique=len(unique), stats=validator.stats(results),
                         seconds=pmi_s)

    # (e) information gain on the device against the CPU
    src, tgt = ig_pairs(rng, ig["n"], ig["d"])
    names = [(f"s{i}", f"t{i}") for i in range(ig["n"])]
    t0 = time.perf_counter()
    filt = InformationGainFilter(k=3, percentile=50.0, device=device)
    res_dev = filt.filter_pairs(names, src, tgt)
    sync()
    ig_s = time.perf_counter() - t0
    ent_dev = [kl_entropy(x, 3, device=device) for x in (src, tgt)]
    t0 = time.perf_counter()
    res_cpu = InformationGainFilter(k=3, percentile=50.0,
                                    device="cpu").filter_pairs(names, src,
                                                               tgt)
    ig_cpu_s = time.perf_counter() - t0
    ent_cpu = [kl_entropy(x, 3, device="cpu") for x in (src, tgt)]
    held_ig = check_ig(res_dev, res_cpu, ent_dev, ent_cpu, ig["n"] // 2)
    step_ms = None
    if on_card:
        x = torch.as_tensor(tgt, dtype=torch.float64, device=device)
        step_ms = cuda_ms(torch, lambda: _pairwise_sq_dists(x), iters=5)
        del x
    log(f"  (e) information gain, n {ig['n']} d {ig['d']} (f64): "
        f"entropies {ent_dev[0]:.6f} / {ent_dev[1]:.6f} nats, within "
        f"{held_ig['entropy_rel_err']:.2e} of the CPU's, gains within "
        f"{held_ig['gain_rel_err']:.2e}; the planted trivial half dropped, "
        f"the independent half kept; the filter {ig_s * 1e3:.1f} ms here, "
        f"{ig_cpu_s * 1e3:.1f} ms on the CPU; the [n, n] distances "
        + (f"{step_ms:.3f} ms (CUDA events)" if step_ms is not None
           else "not timed off the card"))
    result["information_gain"] = dict(held_ig, n=ig["n"], d=ig["d"],
                                      entropies=ent_dev, filter_ms=ig_s * 1e3,
                                      cpu_filter_ms=ig_cpu_s * 1e3,
                                      pairwise_ms=step_ms)

    # (f) V33 training through the CLI on the shards the pipeline wrote
    result["train"] = data_train(torch, workdir / "train", out_dir, meta,
                                 recipe, model_config, device, model_over,
                                 train_steps, timeout_s)
    result["launches"] = dict(mining=launches,
                              train=result["train"]["launches"])
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  {card}: phase 11 in {result['seconds']:.1f} s")
    shutil.rmtree(workdir, ignore_errors=True)
    return result


LOADED = re.compile(r"loaded (\d+) triplets from (\d+) files")


def data_train(torch, workdir: Path, out_dir: Path, meta: dict, recipe: dict,
               model_config, device: str, model_over, steps: int,
               timeout_s: float) -> dict:
    """Phase 11 (f): ``python -m splade_tpu_torch.train v33`` (through
    ``--cli``: the stand-in tokenizer) as one process on the recipe with
    ``train_files`` the pipeline's ``train_shard_*.jsonl``, ``steps``
    steps. Held: the loader read every train row the pipeline wrote, the
    losses are finite, the launches are the ones the code implies."""
    workdir.mkdir(parents=True)
    cfg = json.loads(json.dumps(recipe))
    cfg["data"].update(train_files=[str(out_dir / "train_shard_*.jsonl")],
                       val_files=[])
    cfg["training"].update(log_every_n_steps=1, max_steps=steps)
    (workdir / "config.json").write_text(json.dumps(cfg))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--cli"] + (
        ["--model-config", json.dumps(model_over)] if model_over else []) + [
        "v33", "--config", str(workdir / "config.json"), "--output-dir",
        str(workdir / "run")] + (["--device", "cpu"] if device == "cpu"
                                 else [])
    t0 = time.perf_counter()
    text = run_processes("V33 CLI on the pipeline's shards", [cmd],
                         [repo_env()], [workdir / "cli.log"], timeout_s)[0]
    seconds = time.perf_counter() - t0
    records = [json.loads(line) for line in
               (workdir / "run" / "metrics.jsonl").read_text().splitlines()]
    launches = json.loads([line for line in text.splitlines()
                           if line.startswith("LAUNCHES ")][-1][9:])
    loaded = LOADED.search((workdir / "run" / "training.log").read_text())
    accum = cfg["training"]["gradient_accumulation_steps"]
    want = launches_on(device, expected_launches(model_config, accum, steps,
                                                 2))
    losses = [r["loss"] for r in records]
    rows = int(loaded.group(1)) if loaded else None
    log(f"  (f) V33 CLI on the pipeline's {len(meta['shards'])} train "
        f"shards: the loader read {rows} rows of {meta['train']}; {steps} "
        f"steps, losses {losses}; {seconds:.1f} s")
    hold_launches("V33 CLI on the pipeline's shards", launches, want)
    if rows != meta["train"] or len(records) != steps or not all(
            np.isfinite(x) for x in losses):
        raise SystemExit("V33 CLI on the pipeline's shards: the loader read "
                         f"{rows} rows of {meta['train']}, or the losses "
                         f"{losses} are not {steps} finite ones")
    return dict(rows=rows, losses=losses, launches=launches,
                seconds=seconds)


def data_main(seed: int = 0) -> dict:
    """Phase 11 alone on the card: the kernels built, phase 3's seeded
    22L/768/50K encoder, the stand-in tokenizer, ``data_phase``."""
    import torch

    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    _cuda.library()
    model = SpladeEncoder(ModernBertConfig(), pool_impl="kernel",
                          device="cuda").init_weights(seed)
    model = model.to(torch.bfloat16).eval()
    out = data_phase(torch, model, CharTokenizer(),
                     np.random.default_rng([seed, 12]),
                     Path(__file__).resolve().parent / "build"
                     / "chip_smoke_data", card)
    log(json.dumps({"data_phase11": out}))
    return out


def cli_entry(argv) -> int:
    """``python chip_smoke.py --cli [--model-config JSON]
    {v33,mlm,bench,export,serve} ARGS``: the port's training CLI (``python
    -m splade_tpu_torch.train``), its benchmark CLI through
    ``bench_entry``, its export CLI (``python -m splade_tpu_torch.export``)
    or its server CLI (``python -m splade_tpu_torch.serving.server``, which
    stops on SIGINT), with this script's stand-in tokenizer in place of
    ``create_tokenizer`` (the card machine has no transformers) and, where
    given, a model config's fields over the architecture's (the CPU
    rehearsal's tiny model; export and serve take the architecture from the
    weights and the HF dir, and only the vocabulary from it). Phase 7
    starts the training CLIs alone and under ``torch.distributed.run``,
    phase 8 the benchmark, phase 9 the export and the server; the last line
    is the kernels' launch counts of the run, ``LAUNCHES {...}``. The
    server keeps SERVE_DOC_TOP_K terms an indexed document. The metric
    writer keeps its JSONL sink only (TensorBoard, which the card machine
    lacks, imports TensorFlow where it is installed)."""
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
    sub, rest = argv[0], argv[1:]
    if over and sub not in ("export", "serve"):
        architecture = modernbert.ModernBertConfig
        modernbert.ModernBertConfig = lambda **kw: architecture(
            **{**kw, **over})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sub == "bench":
        rc = bench_entry(rest)
    elif sub == "export":
        from splade_tpu_torch.export.__main__ import main as export_main

        rc = export_main(rest)
    elif sub == "serve":
        from splade_tpu_torch.serving import engine, server

        # random weights make dense documents: keep phase 3's terms a
        # document, as the encoder phase 9 (b) and (c) index with does
        build = engine.build_engine_from_docs
        engine.build_engine_from_docs = lambda *a, **kw: build(
            *a, **{**kw, "doc_top_k": SERVE_DOC_TOP_K})
        rc = server.main(rest)
    else:
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
    _reset_launch_counts()
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
    serve_model = (Path(__file__).resolve().parent / "build"
                   / "chip_smoke_serve_model" / "final_model")
    pretraining = mlm_phase(
        torch, tok, rng, Path(__file__).resolve().parent / "build"
        / "chip_smoke_mlm", args.seed, mlm_recipe(), ModernBertConfig(),
        keep_final=serve_model)
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

    # ---- 8. the benchmark path
    log("[8] benchmark path: the benchmark CLI at full width (sparse "
        "22L/768/50K, dense XLM-R at BGE-M3's shape), exact, postings, "
        "ImpactIndex and dense rows; the teacher's precompute and mining")
    benchmark = bench_phase(
        torch, np.random.default_rng([args.seed, 10]),
        Path(__file__).resolve().parent / "build" / "chip_smoke_bench",
        args.seed, card)
    log(f"[8] done in {benchmark['seconds']:.1f} s")

    # ---- 9. train -> HF export -> serve
    log("[9] train -> HF export -> serve: phase 5's model through the "
        "export CLI, the tiered and the cluster index over phase 3's corpus "
        "behind the HTTP server, the server CLI from the export dir")
    import shutil

    serving9 = serve_phase(
        torch, tok, np.random.default_rng([args.seed, 11]),
        Path(__file__).resolve().parent / "build" / "chip_smoke_serve",
        serve_model, syn_terms, syn_vals, card)
    shutil.rmtree(serve_model.parent, ignore_errors=True)
    log(f"[9] done in {serving9['seconds']:.1f} s")

    # ---- 10. the mesh-sharded indexes on one card
    log(f"[10] the mesh-sharded indexes: {MESH_SHARDS} shards on cuda:0, "
        "postings, tiered and cluster over phase 3's corpus, the dense "
        "index over its 10,000 documents, phase 3's seeded model")
    mesh_model = SpladeEncoder(ModernBertConfig(), pool_impl="kernel",
                               device="cuda").init_weights(args.seed)
    mesh_model = mesh_model.to(torch.bfloat16).eval()
    mesh10 = mesh_phase(
        torch, mesh_model, tok, syn_terms, syn_vals, pool_docs, dense_docs,
        queries, Path(__file__).resolve().parent / "build"
        / "chip_smoke_mesh", card, ["cuda:0"] * MESH_SHARDS)
    torch.cuda.empty_cache()
    log(f"[10] done in {mesh10['seconds']:.1f} s")

    # ---- 11. the offline data tier feeding V33 training
    log(f"[11] the offline data tier: {DATA_RAW} raw samples -> the "
        "preprocessing pipeline -> encoder mining through the pool forward "
        "-> IDF, PMI, information gain -> the V33 CLI on the pipeline's "
        "shards; phase 3's seeded 22L/768/50K model")
    data11 = data_phase(torch, mesh_model, tok,
                        np.random.default_rng([args.seed, 12]),
                        Path(__file__).resolve().parent / "build"
                        / "chip_smoke_data", card)
    del mesh_model
    torch.cuda.empty_cache()
    log(f"[11] done in {data11['seconds']:.1f} s")
    data_by_path = {
        name: {"data tier, V33 CLI (phase 11)": data11["train"]["launches"][
            name]} for name in ("fused_splade_pool", "fused_splade_bwd_match",
                                "fused_splade_bwd_dh", "fused_splade_bwd_dw")}
    data_by_path["fused_splade_pool"]["data tier, encoder mining (phase 11)"] = (
        data11["launches"]["mining"])
    mesh_by_path = {
        name: {f"mesh {kind} (phase 10)": mesh10[kind]["launches"][name]
               for kind in ("postings", "tiered", "cluster", "dense")}
        for name in ("fused_splade_pool", "rescore_match")}
    for name, paths in mesh_by_path.items():
        for path, n in paths.items():
            if n <= 0 and not (name == "rescore_match" and "dense" in path):
                raise SystemExit(f"kernel {name} was launched no time on "
                                 f"{path}")
    serve9_by_path = {
        name: {"serving, tiered (phase 9)":
                   serving9["tiered"]["launches"][name],
               "serving, cluster (phase 9)":
                   serving9["cluster"]["launches"][name],
               "server CLI (phase 9)": sum(
                   run.get(name, 0)
                   for run in serving9["server_cli"]["launches"])}
        for name in ("fused_splade_pool", "rescore_match")}
    bench_by_path = {name: {f"benchmark run ({run})": got[name]
                            for run, got in benchmark["launches"].items()}
                     for name in ("fused_splade_pool", "rescore_match")}
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
                    for path, got in dp_launches.items()},
                 **bench_by_path["fused_splade_pool"],
                 **serve9_by_path["fused_splade_pool"],
                 **mesh_by_path["fused_splade_pool"],
                 **data_by_path["fused_splade_pool"]},
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
             launches_by_path={"serving": launches["rescore_match"],
                               **bench_by_path["rescore_match"],
                               **serve9_by_path["rescore_match"],
                               **mesh_by_path["rescore_match"]},
             **{k: resc[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
             shapes=[resc, serving9["cluster"]["rescore"]]
             + [dict(mesh10[kind]["rescore"], path=f"mesh {kind} shard 0")
                for kind in ("postings", "tiered", "cluster")],
             ptxas=ptxas["rescore_kernel"]),
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
                                 for path, got in dp_launches.items()},
                              **data_by_path[name]},
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
    log(json.dumps({"benchmark": benchmark,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"serving_phase9": serving9,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"mesh_phase10": mesh10,
                    "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"data_phase11": data11,
                    "seconds": time.perf_counter() - t_start}))
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
