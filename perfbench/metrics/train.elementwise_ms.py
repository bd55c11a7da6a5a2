"""Device ms a step, in the traced training steps, of kernels that are
neither GEMMs nor the port's own kernels (encoder: models/modernbert.py).
The name rule: a GEMM is a kernel whose name holds one of ``GEMM``; the
port's kernels are those of ``PORT``; copies and sets are not kernels."""

GEMM = ("gemm", "cutlass", "nvjet", "xmma", "cublas", "matmul", "sm90_",
        "sm80_", "ampere_", "hopper_")
PORT = ("fused_splade", "splash", "rescore")


def is_elementwise(name: str) -> bool:
    low = name.lower()
    return not any(g in low for g in GEMM) and not any(p in low for p in PORT)


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps_traced", 0)
    if ctx.get("kind") not in ("v33", "mlm") or trace is None or not steps:
        return None
    return 1e3 * sum(s for n, s in trace.kernels if is_elementwise(n)) / steps
