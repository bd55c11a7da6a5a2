"""Splash attention forward at [B, N, S, D].

Source of the formula: PERF.md section 6, bounds ("attention ... their
bytes at 3.35 TB/s"), as ``chip_smoke.py::check_splash`` counts them: q,
k, v read and out written once in bfloat16, lse written (f32 a row), the
segment ids read. The least bytes time; the operations of the allowed
pairs are below it at these shapes.
"""

from perfbench.rooflines.peaks import HBM_BYTES


def moved(B: int, N: int, S: int, D: int) -> float:
    tensor = B * S * N * D
    return 4 * tensor * 2 + B * N * S * 4 + B * S * 4


def least(B, N, S, D, **_) -> float:
    return moved(B, N, S, D) / HBM_BYTES
