"""The forward and backward FLOPs the window's completed steps need (three
forward passes' worth, remat's recompute not counted; rooflines/encoder.py)
over the window, less the time the benchmark spent starting and stopping
its tracer, at the bfloat16 peak (train step: make_train_step,
train/state.py, losses/v33.py, the MLM loss)."""

from perfbench.core.readers import mfu_pct
from perfbench.rooflines.encoder import forward_flops


def step_flops(ctx, lengths: dict) -> float:
    cfg = ctx["model"]
    if ctx["kind"] == "mlm":
        rows = lengths["rows"]
        return 3 * forward_flops(cfg, rows,
                                 projected=ctx["masked"] * (rows > 0).sum())
    return 3 * sum(forward_flops(cfg, v) for v in lengths.values())


def read(ctx):
    if ctx.get("kind") not in ("v33", "mlm") or not ctx.get("lengths"):
        return None
    w = ctx["window"]
    flops = sum(step_flops(ctx, ln) for ln in ctx["lengths"])
    return mfu_pct(flops, w["window_s"] - ctx.get("tracer_s", 0.0))
