"""The SPLADE pool forward: logits = h W^T + b over the vocabulary, then
the masked max over positions (``ops/fused_splade.py``'s forward).

Source of the formula: PERF.md section 6, bounds ("pool forward and match
pass 2*valid*H*V operations at 989 TFLOP/s"); bytes: each input read once
(h and W in bfloat16, the bias and the mask), the [B, V] maxima and the
[B, S] token weights written once in float32.
"""

from perfbench.rooflines.peaks import least_s


def ops_bytes(B: int, S: int, H: int, V: int, valid: float):
    ops = 2.0 * valid * H * V
    moved = B * S * H * 2 + V * H * 2 + V * 4 + B * S * 4 + B * V * 4 \
        + B * S * 4
    return ops, moved


def least(B, S, H, V, valid, **_) -> float:
    return least_s(*ops_bytes(B, S, H, V, valid))
