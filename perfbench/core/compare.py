"""The numbers that decide ``correct``, each beside its limit.

Training (both recipes): the loss of each checked step, the first
gradient as the optimizer got it, and the parameters' change after the
checked steps, the last two by the worst leaf: the gap between the
program's norm of a leaf and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of both.

Search: for a sample of served requests, each served document's score
against the reference's exact score of that document, and the served
documents' exact scores rank by rank against the reference's own ranking,
both over the larger of the request's best reference score and the median
request's; the widest gap of all.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

#: a leaf counts when its reference gradient is at least this share of the
#: median leaf's
MOVING_LEAF = 1e-3


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= MOVING_LEAF * med]


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Sequence[str]) -> Tuple[float, str]:
    med = statistics.median(ref[n] for n in leaves)
    worst, where = 0.0, ""
    for n in leaves:
        gap = abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, where = gap, n
    return worst, where


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    leaves: Sequence[str]) -> float:
    """The median over leaves of the same gap as ``worst_leaf_gap``."""
    med = statistics.median(ref[n] for n in leaves)
    return statistics.median(abs(prog.get(n, 0.0) - ref[n])
                             / max(ref[n], med, 1e-30) for n in leaves)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog, ref))


def train_readings(prog_losses, ref_losses, prog_grad1, ref_grad1,
                   prog_change, ref_change) -> Dict[str, float]:
    leaves = moving_leaves(ref_grad1)
    g, g_leaf = worst_leaf_gap(prog_grad1, ref_grad1, leaves)
    c, c_leaf = worst_leaf_gap(prog_change, ref_change, leaves)
    return {"loss_gap": loss_gap(prog_losses, ref_losses),
            "grad_gap": g, "update_gap": c,
            "grad_gap_median": median_leaf_gap(prog_grad1, ref_grad1, leaves),
            "update_gap_median": median_leaf_gap(prog_change, ref_change,
                                                 leaves),
            "_grad_leaf": g_leaf, "_update_leaf": c_leaf,
            "_leaves": len(leaves), "_of": len(ref_grad1)}


def search_readings(served: List[List[Tuple[int, float]]],
                    exact: List[Dict[int, float]],
                    ranked: List[List[float]]) -> Dict[str, float]:
    """served[r]: (doc, score) of request r as the program answered it;
    exact[r]: the reference's exact score of each document it needs;
    ranked[r]: the reference's top-k scores of request r. Each gap is over
    the larger of the request's best reference score and the median
    request's, as a leaf's over its own norm or the median leaf's: a query
    whose terms all lie at the relu's edge has a best score near 0, and
    the program's rounding moves its few small scores by as much. A served
    document that is not in the corpus, or a score that is not a number,
    counts under ``unknown_docs``."""
    tops = [want[0] if want else 0.0 for want in ranked]
    med = statistics.median(tops) if tops else 0.0
    score, rank, unknown = [], [], 0
    for got, ex, want, top in zip(served, exact, ranked, tops):
        scale = max(top, med, 1e-30)
        worst = 0.0
        for doc, s in got:
            if doc not in ex or s != s:
                unknown += 1
                continue
            worst = max(worst, abs(s - ex[doc]) / scale)
        score.append(worst)
        mine = sorted((ex.get(doc, 0.0) for doc, _ in got), reverse=True)
        mine += [0.0] * (len(want) - len(mine))
        rank.append(max((abs(a - b) / scale for a, b in zip(mine, want)),
                        default=0.0))

    def spread(x):
        x = sorted(x)
        return [x[len(x) // 2], x[(9 * len(x)) // 10], x[-1]] if x else []

    return {"score_gap": max(score, default=0.0),
            "rank_gap": max(rank, default=0.0), "unknown_docs": unknown,
            "_p50_p90_max": {"score": spread(score), "rank": spread(rank)}}


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} for every limited reading."""
    return {n: {"value": readings.get(n), "limit": lim}
            for n, lim in limits.items()}
