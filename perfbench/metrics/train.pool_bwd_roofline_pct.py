"""The pool backward's least time (rooflines/pool_bwd.py) for each traced
forward call that took a gradient, over the device time of the kernels
launched inside the autograd node of its backward, in the traced V33
training steps."""

from perfbench.core.readers import roofline_pct
from perfbench.rooflines import pool_bwd


def read(ctx):
    if ctx.get("kind") != "v33":
        return None
    recs = [r for r in ctx["records"].get("pool_fwd", []) if r["grad"]]
    return roofline_pct(ctx, [("pool_bwd", pool_bwd.least, recs)])
