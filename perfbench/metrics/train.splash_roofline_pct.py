"""The splash attention's least bytes time, forward (every traced call,
remat's recompute included) and backward (every traced backward node, at
the shape of the traced calls), over the device time of the kernels
launched inside the forward calls and the backward nodes (attention
kernels: ops/splash_attention.py), in the traced training steps."""

from perfbench.core.readers import roofline_pct, scalar
from perfbench.rooflines import splash_bwd, splash_fwd


def read(ctx):
    trace = ctx.get("trace")
    recs = ctx["records"].get("splash_fwd", []) \
        if ctx.get("kind") in ("v33", "mlm") else []
    if trace is None or not recs or not trace.scope_n.get("splash_bwd"):
        return None
    per_call = sum(splash_bwd.least(**{k: scalar(v) for k, v in r.items()})
                   for r in recs) / len(recs)
    n_bwd = trace.scope_n["splash_bwd"]
    return roofline_pct(ctx, [
        ("splash_fwd", splash_fwd.least, recs),
        ("splash_bwd", lambda **_: per_call * n_bwd / len(recs), recs)])
