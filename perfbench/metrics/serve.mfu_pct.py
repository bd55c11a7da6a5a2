"""The model FLOPs of the queries' valid tokens in the engine calls inside
the traced window (rooflines/encoder.py, the SPLADE pool projecting every
valid token), over the sum of those calls' wall times at the bfloat16 peak
(model step: models/modernbert.py, models/splade.py)."""

from perfbench.core.readers import mfu_pct, traced_calls
from perfbench.rooflines.encoder import forward_flops


def read(ctx):
    if ctx.get("kind") != "search":
        return None
    calls = traced_calls(ctx)
    if not calls:
        return None
    tok, S = ctx["tok"], ctx["query_max_length"]
    lengths = [min(len(tok.codes(q)), S) for c in calls for q in c[2]]
    return mfu_pct(forward_flops(ctx["model"], lengths),
                   sum(c[1] - c[0] for c in calls))
