"""The exact rescore of B x C candidates from the doc-major block (M term
slots a document, T query terms).

Source of the formula: PERF.md section 6, bounds ("rescore ... bytes at
3.35 TB/s") and ``chip_smoke.py::rescore_bound``: each distinct document
row the candidates name read once (M int32 terms, M int8 values, an f32
scale), each int32 candidate id read and each f32 score written once, the
queries (T int32 ids and T f32 weights a row) read once. Bound by bytes at
these shapes.
"""

from perfbench.rooflines.peaks import HBM_BYTES


def moved(B: int, C: int, M: int, T: int, rows: float) -> float:
    return rows * (5 * M + 4) + B * C * 8 + B * T * 8


def least(B, C, M, T, rows, **_) -> float:
    return moved(B, C, M, T, rows) / HBM_BYTES
