"""The rescore's least time (rooflines/rescore.py) over the device time of
the kernels launched inside its calls (rescore kernel:
ops/rescore_kernel.py), in the traced window of a serving run."""

from perfbench.core.readers import roofline_pct
from perfbench.rooflines import rescore


def read(ctx):
    if ctx.get("kind") != "search":
        return None
    return roofline_pct(ctx, [("rescore", rescore.least,
                               ctx["records"].get("rescore"))])
