"""The pool forward's least time (rooflines/pool_fwd.py) over the device
time of the kernels launched inside its calls (pool kernels:
ops/fused_splade.py), in the traced window of a serving run."""

from perfbench.core.readers import roofline_pct
from perfbench.rooflines import pool_fwd


def read(ctx):
    if ctx.get("kind") != "search":
        return None
    return roofline_pct(ctx, [("pool_fwd", pool_fwd.least,
                               ctx["records"].get("pool_fwd"))])
