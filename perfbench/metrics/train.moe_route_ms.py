"""Device ms a step, in the traced training steps, of the MoE layers'
work outside the held experts' products: the kernels in the program's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` ranges
(models/deepseek_v3.py: the float32 router and top-k, the sort of the
slots by expert and the gather of their rows, the weighted scatter back),
forward calls with remat's recompute; their backward runs outside the
ranges and is not counted."""

SCOPES = ("moe_route", "moe_dispatch", "moe_combine")


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps_traced", 0)
    if trace is None or not steps or not ctx.get("moe"):
        return None
    busy = sum(trace.scope_s.get(s, 0.0) for s in SCOPES)
    return 1e3 * busy / steps if busy else None
