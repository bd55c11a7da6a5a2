"""Rank 0's gradient all-reduce a step in the window of a data-parallel
run (parallel/mesh.py: ``GradReducer.last_ms``, CUDA events around the
copies in and out and the bucketed SUM, read after each step), the mean
over the window's steps."""

import numpy as np


def read(ctx):
    times = [t for t in ctx.get("allreduce_ms", []) if t is not None]
    return float(np.mean(times)) if times else None
