"""The held experts' grouped products (models/deepseek_v3.py), forward and
backward: their least time (``rooflines/mla_moe.py``) over the device time
of the kernels in the program's ``moe.experts`` range (each traced call,
remat's recompute included) and in the products' autograd nodes
(``GroupedMmBackward``, two a call's backward), in the traced training
steps. A call's rows are the window's mean, from the MoE layers' counters
(held slots over calls); the experts and widths are the model's."""

from perfbench.rooflines.mla_moe import experts_least


def read(ctx):
    trace, layers, cfg = ctx.get("trace"), ctx.get("moe"), ctx.get("model")
    if trace is None or not layers or cfg is None:
        return None
    busy = trace.scope_s.get("moe_experts", 0.0) \
        + trace.scope_s.get("moe_experts_bwd", 0.0)
    calls = trace.scope_n.get("moe_experts", 0)
    nodes = trace.scope_n.get("moe_experts_bwd", 0)
    counted = sum(x["calls"] for x in layers)
    if not busy or not calls or not nodes or not counted:
        return None
    shape = dict(rows=sum(x["held_slots"] for x in layers) / counted,
                 experts=layers[0]["held_experts"], H=cfg["hidden_size"],
                 I=cfg["moe_intermediate_size"])
    return 100.0 * (calls * experts_least(**shape) + nodes / 2
                    * experts_least(backward=True, **shape)) / busy
