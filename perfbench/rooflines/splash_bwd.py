"""Splash attention backward at [B, N, S, D] (dq with delta, then dk/dv).

Source of the formula: PERF.md section 6 (attention bounds in bytes), as
``chip_smoke.py::check_splash`` counts them: the dq pass reads q, k, v, dO
and out (bfloat16), lse and the segment ids, and writes dq (float32) and
delta; the dk/dv pass reads q, k, v, dO, lse, delta and the segment ids
and writes dk (float32) and dv (bfloat16).
"""

from perfbench.rooflines.peaks import HBM_BYTES


def moved(B: int, N: int, S: int, D: int) -> float:
    tensor, row, seg = B * S * N * D, B * N * S * 4, B * S * 4
    dq = 5 * tensor * 2 + row + seg + tensor * 4 + row
    dkv = 4 * tensor * 2 + 2 * row + seg + tensor * (4 + 2)
    return dq + dkv


def least(B, N, S, D, **_) -> float:
    return moved(B, N, S, D) / HBM_BYTES
