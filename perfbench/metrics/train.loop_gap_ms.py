"""Mean host ms from one ``step_fn`` return to the next call in the
window (trainer and data: train/trainer.py, train/mlm.py, data/*), from
the benchmark's wrapper on the trainer instance's ``step_fn``; the gaps in
which the benchmark started or stopped its tracer are left out."""

import numpy as np


def read(ctx):
    gaps = ctx.get("loop_gaps_ms")
    if ctx.get("kind") not in ("v33", "mlm") or not gaps:
        return None
    return float(np.mean(gaps))
