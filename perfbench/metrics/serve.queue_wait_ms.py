"""Mean ms from a request's due time to the start of the engine call that
carries it (batcher layer: serving/batcher.py, serving/server.py), over
the requests carried by calls inside the traced window. The batcher is
first in, first out, so the window's requests fill the engine calls in
order."""

import numpy as np

from perfbench.core.readers import traced_calls


def read(ctx):
    if ctx.get("kind") != "search" or not ctx.get("spans"):
        return None
    w = ctx["window"]
    inside = {id(c) for c in traced_calls(ctx)}
    waits, i = [], 0
    for call in ctx["spans"]:
        n = len(call[2])
        if id(call) in inside:
            due = w["t0"] + w["due"][i:i + n]
            waits.extend(call[0] - due)
        i += n
    return float(np.mean(waits) * 1e3) if waits else None
