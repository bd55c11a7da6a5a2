"""Matrix products for the reference and for its control.

The configurations compute their products in bfloat16 (autocast over
float32 master weights when training, bfloat16 weights when serving). The
reference computes them in float32 with TF32 off. The control is the
reference one precision step below bfloat16: each operand of every product
rounded to float8 e4m3 with a per-tensor scale (its largest magnitude to
448, the format's largest finite value), the product accumulated in
float32, as an fp8 GEMM with float32 accumulation computes it; the
backward's products round theirs too.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, back in float32."""
    x32 = x.float()
    scale = x32.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x32 / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to fp8; the backward's two products
    round their operands (the incoming gradient among them) too."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = round_fp8(g)
        da = torch.matmul(g8, b8.transpose(-1, -2))
        db = torch.matmul(a8.transpose(-1, -2), g8)
        # broadcast batch dimensions back to each operand's shape
        while da.dim() > a8.dim():
            da = da.sum(0)
        while db.dim() > b8.dim():
            db = db.sum(0)
        return da, db


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


PRODUCTS = {"f32": torch.matmul, "fp8": fp8_mm}
