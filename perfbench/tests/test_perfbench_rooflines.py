"""The operations, bytes and FLOP counts against hand counts at small
shapes, and the trace reader on a hand-made trace."""


import numpy as np
import pytest

from perfbench.core.trace import read_trace
from perfbench.core.bench import metric_reader as load_reader
from perfbench.rooflines import (encoder, peaks, pool_bwd, pool_fwd, rescore,
                                 splash_bwd, splash_fwd)

CFG = dict(hidden_size=4, intermediate_size=6, vocab_size=10,
           num_hidden_layers=3, global_attn_every_n_layers=3,
           local_attention=2)


def test_pool_forward_counts():
    ops, moved = pool_fwd.ops_bytes(B=2, S=3, H=4, V=10, valid=5)
    assert ops == 2 * 5 * 4 * 10
    assert moved == 2 * 3 * 4 * 2 + 10 * 4 * 2 + 10 * 4 + 2 * 3 * 4 \
        + 2 * 10 * 4 + 2 * 3 * 4
    assert pool_fwd.least(2, 3, 4, 10, 5) == max(ops / peaks.BF16_FLOPS,
                                                 moved / peaks.HBM_BYTES)


def test_pool_backward_counts():
    got = pool_bwd.least(B=1, S=2, H=4, V=10, valid=2, matches=3)
    ops_s = 2 * 2 * 4 * 10 / 989e12 + 2 * (2 * 3 * 4) / 67e12
    moved = 1 * 2 * 4 * 2 + 10 * 4 * 2 + 40 + 8 + 80 + 32 + 160
    assert got == pytest.approx(max(ops_s, moved / 3.35e12))


def test_splash_and_rescore_bytes():
    t = 1 * 2 * 3 * 4
    assert splash_fwd.moved(B=1, N=3, S=2, D=4) == 4 * t * 2 + 24 + 8
    row, seg = 1 * 3 * 2 * 4, 8
    assert splash_bwd.moved(1, 3, 2, 4) == (
        5 * t * 2 + row + seg + t * 4 + row) + (
        4 * t * 2 + 2 * row + seg + t * 6)
    assert rescore.moved(B=2, C=3, M=4, T=5, rows=6) == 6 * 24 + 48 + 80


def test_encoder_flops_by_hand():
    # one row of 3 valid tokens: layer 0 global (9 pairs), layers 1-2 local
    # at half window 1 (3 + 2*2 = 7 pairs)
    H, I, V = 4, 6, 10
    dense = 3 * 2 * (4 * H * H + 3 * H * I) * 3
    attn = 4 * H * (1 * 9 + 2 * 7)
    head = 2 * H * H * 3 + 2 * H * V * 3
    assert encoder.forward_flops(CFG, [3, 0]) == dense + attn + head
    assert encoder.forward_flops(CFG, [3], projected=1) == \
        dense + attn + 2 * H * H + 2 * H * V
    L = np.array([1, 2, 5, 9])
    brute = [sum(1 for i in range(n) for j in range(n) if abs(i - j) <= 2)
             for n in L]
    assert encoder.local_pairs(L, 2).tolist() == brute


def test_mfu_reading():
    read = load_reader("train.mfu_pct")
    ctx = {"kind": "v33", "model": CFG, "window": {"window_s": 2.0},
           "tracer_s": 1.0,
           "lengths": [{"q": np.array([[3]])}, {"q": np.array([[3]])}]}
    flops = 2 * 3 * encoder.forward_flops(CFG, [3])
    assert read(ctx) == pytest.approx(100 * flops / peaks.BF16_FLOPS)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    args = {"correlation": corr} if corr is not None else {}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reader_attributes_kernels_to_scopes():
    events = [
        _ev("user_annotation", "perfbench.pool_fwd", 0, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _ev("kernel", "pool_kernel", 20, 30, tid=7, corr=1),
        _ev("cpu_op", "autograd::engine::evaluate_function: "
            "_FusedPoolBackward", 100, 20, tid=2),
        _ev("cpu_op", "_FusedPoolBackward", 101, 18, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 105, 1, tid=2, corr=2),
        _ev("kernel", "bwd_kernel", 110, 40, tid=7, corr=2),
        _ev("cpu_op", "aten::add", 150, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 185, 1, corr=3),
        _ev("kernel", "add_kernel", 200, 10, tid=7, corr=3),
    ]
    t = read_trace(events, window_s=300e-6)
    assert t.busy_s == pytest.approx(80e-6)
    assert t.scope_s == {"pool_fwd": pytest.approx(30e-6),
                         "pool_bwd": pytest.approx(40e-6)}
    assert t.scope_n == {"pool_fwd": 1, "pool_bwd": 1}
    gaps = dict(t.idle_gaps)
    # the backward's thread was idle in the middle of the first gap
    assert gaps["host outside any traced op"] == pytest.approx(60e-6)
    assert gaps["aten::add"] == pytest.approx(50e-6)
    assert t.device_ops[0] == ("bwd_kernel", pytest.approx(40e-6))


def test_elementwise_name_rule():
    rule = load_reader("train.elementwise_ms").__globals__["is_elementwise"]
    assert rule("void at::native::vectorized_elementwise_kernel<4>")
    assert not rule("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT")
    assert not rule("sm90_xmma_gemm_bf16bf16_bf16f32")
    assert not rule("fused_splade_fwd_kernel")
    assert not rule("splash_attention_fwd_kernel")
