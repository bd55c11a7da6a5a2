"""The SPLADE pool backward: dh and dW of the masked max.

Source of the formula: PERF.md section 6, bounds ("pool backward its own
work: recompute plus an f32 row of H a match at 67 TFLOP/s"), as
``chip_smoke.py::check_pool_backward`` counts it: the recompute of the
scores, 2*valid*H*V operations on the tensor cores, plus, for each (row,
vocabulary) maximum that carries a gradient (``matches``: the pooled
values above 0), one float32 row of H multiply-adds into dh and one into
dW on the float32 lanes, the two times added; bytes: h, W (bfloat16), the
bias, the mask, the maxima and their gradient read once, dh [B, S, H] and
dW [V, H] written once in float32.
"""

from perfbench.rooflines.peaks import BF16_FLOPS, FP32_OPS, HBM_BYTES


def least(B: int, S: int, H: int, V: int, valid: float, matches: float,
          **_) -> float:
    ops_s = 2.0 * valid * H * V / BF16_FLOPS + 2 * (2.0 * matches * H) \
        / FP32_OPS
    moved = (B * S * H * 2 + V * H * 2 + V * 4 + B * S * 4 + 2 * B * V * 4
             + B * S * H * 4 + V * H * 4)
    return max(ops_s, moved / HBM_BYTES)
