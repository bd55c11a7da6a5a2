"""The whole step's model FLOPs of a DeepSeek-V3 backbone's V33 steps
(``rooflines/mla_moe.py``: MLA, attention within the causal segment mask,
router, shared experts, the held experts' slots as the MoE layers'
counters report their share, the dense layer, the pool; three forward
passes' worth, remat's recompute not counted) over the window, less the
time the benchmark spent starting and stopping its tracer, at the
bfloat16 peak (train step: make_train_step, models/deepseek_v3.py)."""

from perfbench.core.readers import mfu_pct
from perfbench.rooflines.mla_moe import forward_flops


def read(ctx):
    layers = ctx.get("moe")
    if ctx.get("kind") != "v33" or not layers or not ctx.get("lengths"):
        return None
    held = sum(x["held_slots"] for x in layers)
    slots = held + sum(x["offchip_slots"] for x in layers)
    if not slots:
        return None
    flops = 3 * sum(forward_flops(ctx["model"], ln, held / slots)
                    for ln in ctx["lengths"])
    w = ctx["window"]
    return mfu_pct(flops, w["window_s"] - ctx.get("tracer_s", 0.0))
