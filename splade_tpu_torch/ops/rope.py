"""RoPE on the splash route: q and k rotated straight from the QKV product.

The encoder's rotation (``models/modernbert.py::apply_rope``, the
rotate-half convention with cos/sin tables ``[S, D]`` shared by the batch
or ``[B, S, D]`` gathered by packed positions) as one
``torch.autograd.Function`` over two hand-written kernels
(``csrc/rope.cu``), taken where ``fused_rope_applies``: the splash route's
bf16 QKV product on the card with f32 tables and D = 64, which is what
training under autocast hands it.

- ``rope_qkv(qkv, cos, sin)`` takes the ``[B, S, 3, N, D]`` product and
  returns (q, k, v), each ``[B, S, N, D]``: q and k rotated, computed in
  f32 and rounded once to the product's dtype, and contiguous; v the
  product's own strided view. In bf16 these are bitwise the values the
  splash kernels got before from the cast of the eager f32 chain.
- Its backward takes the gradients of q, k and v and writes the product's
  whole gradient ``[B, S, 3, N, D]`` in one pass: dq and dk rotated back in
  f32 and rounded once, dv copied into its slot.

No TPU kernel is replaced: XLA fuses the JAX package's plain rotation,
which eager PyTorch runs as a dozen kernels each way (``csrc/rope.cu``
says what bounds the pair and how it is laid out). Everything else (CPU
tensors, f32 or f64 products, bf16 tables, another head width, the sdpa
route) keeps the model's plain ``apply_rope``.

On CUDA tensors the wrappers ``rope_qkv_fwd`` and ``rope_qkv_bwd`` launch
the kernels or raise; on CPU tensors they run the plain versions
``rope_qkv_fwd_plain`` and ``rope_qkv_bwd_plain``. There is no fallback
between the two.
"""

from __future__ import annotations

from typing import Tuple

import torch

from splade_tpu_torch.ops import _cuda
from splade_tpu_torch.ops.splash_attention import KERNEL_HEAD_DIM


def fused_rope_applies(qkv: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> bool:
    """Whether ``rope_qkv`` takes this product: a bf16 one on the card with
    heads of ``KERNEL_HEAD_DIM`` and f32 tables that need no gradient."""
    return (qkv.is_cuda and qkv.dtype == torch.bfloat16
            and qkv.shape[-1] == KERNEL_HEAD_DIM
            and cos.dtype == sin.dtype == torch.float32
            and not (cos.requires_grad or sin.requires_grad))


def _tables(cos: torch.Tensor, sin: torch.Tensor) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """cos, sin broadcast against ``[B, S, N, D]``."""
    if cos.dim() == 2:
        return cos[None, :, None, :], sin[None, :, None, :]
    return cos[:, :, None, :], sin[:, :, None, :]


def _wide(*dtypes: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: f32, or f64 for f64."""
    out = torch.float32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def rope_qkv_fwd_plain(qkv: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch: ``[2, B, S, N, D]``
    (q, then k) in qkv's dtype, ``y = x * c + rotate_half(x) * s`` computed
    in f32 (f64 for f64) and rounded once."""
    wide = _wide(qkv.dtype, cos.dtype)
    c, s = (t.to(wide) for t in _tables(cos, sin))
    d2 = qkv.shape[-1] // 2
    with torch.autocast(qkv.device.type, enabled=False):
        x = qkv[:, :, :2].movedim(2, 0).to(wide)         # [2, B, S, N, D]
        rotated = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
        return (x * c + rotated * s).to(qkv.dtype).contiguous()


def rope_qkv_bwd_plain(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: the gradient of
    the product, ``[B, S, 3, N, D]`` in ``dtype``, with ``dx = g * c +
    rotate_half_transposed(g * s)`` computed in f32 (f64 for f64) and
    rounded once, and dv in its slot."""
    wide = _wide(dq.dtype, dk.dtype, cos.dtype)
    c, s = (t.to(wide) for t in _tables(cos, sin))
    d2 = dq.shape[-1] // 2
    with torch.autocast(dq.device.type, enabled=False):
        g = torch.stack([dq, dk]).to(wide)               # [2, B, S, N, D]
        gs = g * s
        dx = (g * c + torch.cat([gs[..., d2:], -gs[..., :d2]], dim=-1)
              ).to(dtype)
        return torch.stack([dx[0], dx[1], dv.to(dtype)], dim=2)


def _table_args(cos: torch.Tensor, sin: torch.Tensor, B: int, S: int,
                D: int, dev) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The tables as the kernels read them, f32 and contiguous, and the
    elements between batch rows (0 for tables the batch shares)."""
    if tuple(cos.shape) not in ((S, D), (B, S, D)) or cos.shape != sin.shape:
        raise ValueError(f"cos {tuple(cos.shape)}, sin {tuple(sin.shape)} "
                         f"must both be [{S}, {D}] or [{B}, {S}, {D}]")
    cos, sin = (_aligned(t.to(device=dev, dtype=torch.float32).contiguous())
                for t in (cos, sin))
    return cos, sin, 0 if cos.dim() == 2 else S * D


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` from a 16-byte aligned address, as the kernels' vector loads
    read it: a contiguous copy where it is not (``contiguous`` keeps a
    contiguous view at any storage offset)."""
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _check_head_dim(D: int) -> None:
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {D}: the RoPE kernels are built for "
                         f"D = {KERNEL_HEAD_DIM}")


def _launch_fwd(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv {tuple(qkv.shape)} must be [B, S, 3, N, D]")
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"qkv is {qkv.dtype}: the RoPE kernels take bf16")
    B, S, _, N, D = qkv.shape
    _check_head_dim(D)
    qkv = _aligned(qkv.contiguous())
    cos, sin, table_batch = _table_args(cos, sin, B, S, D, qkv.device)
    out = torch.empty((2, B, S, N, D), dtype=torch.bfloat16,
                      device=qkv.device)
    if out.numel() == 0:
        return out
    entry = "splade_rope_qkv_fwd"
    code = getattr(_cuda.library(), entry)(
        qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
        B, S, N, D, table_batch, _cuda.stream_ptr(qkv))
    _cuda.check(code, entry)
    rope_qkv_fwd.launches += 1
    return out


def _grad(name: str, g: torch.Tensor, shape) -> torch.Tensor:
    """``g`` as a bf16 tensor the backward kernel reads through its
    strides, 16 bytes at a time from an aligned address (no copy when it
    already is one)."""
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(g.shape)} must be {tuple(shape)}")
    g = g.to(torch.bfloat16)
    if g.stride(-1) != 1 or any(s % 8 for s in g.stride()[:-1]):
        g = g.contiguous()
    return _aligned(g)


def _launch_bwd(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    if dtype != torch.bfloat16:
        raise ValueError(f"the RoPE backward kernel writes bf16, not {dtype}")
    if dq.dim() != 4:
        raise ValueError(f"dq {tuple(dq.shape)} must be [B, S, N, D]")
    B, S, N, D = dq.shape
    _check_head_dim(D)
    grads = [_grad(name, g, dq.shape)
             for name, g in (("dq", dq), ("dk", dk), ("dv", dv))]
    cos, sin, table_batch = _table_args(cos, sin, B, S, D, dq.device)
    dqkv = torch.empty((B, S, 3, N, D), dtype=torch.bfloat16,
                       device=dq.device)
    if dqkv.numel() == 0:
        return dqkv
    entry = "splade_rope_qkv_bwd"
    code = getattr(_cuda.library(), entry)(
        *(g.data_ptr() for g in grads), cos.data_ptr(), sin.data_ptr(),
        dqkv.data_ptr(), *(s for g in grads for s in g.stride()[:3]),
        B, S, N, D, table_batch, _cuda.stream_ptr(dq))
    _cuda.check(code, entry)
    rope_qkv_bwd.launches += 1
    return dqkv


def rope_qkv_fwd(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """q and k of ``qkv`` rotated, ``[2, B, S, N, D]`` in qkv's dtype: the
    forward kernel on CUDA tensors (bf16 only), its plain version on CPU
    tensors."""
    if qkv.is_cuda:
        return _launch_fwd(qkv, cos, sin)
    return rope_qkv_fwd_plain(qkv, cos, sin)


def rope_qkv_bwd(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, dtype: torch.dtype
                 ) -> torch.Tensor:
    """The product's gradient ``[B, S, 3, N, D]`` in ``dtype`` from the
    gradients of q, k and v: the backward kernel on CUDA tensors (bf16
    only), its plain version on CPU tensors."""
    if dq.is_cuda:
        return _launch_bwd(dq, dk, dv, cos, sin, dtype)
    return rope_qkv_bwd_plain(dq, dk, dv, cos, sin, dtype)


class _RopeQKV(torch.autograd.Function):
    """(q, k, v) of the product, q and k rotated; the backward needs only
    the tables. ``custom_fwd``/``custom_bwd`` run the backward under the
    forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, cos, sin):
        q, k = rope_qkv_fwd(qkv, cos, sin)
        ctx.save_for_backward(cos, sin)
        ctx.dtype = qkv.dtype
        return q, k, qkv[:, :, 2]

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dq, dk, dv):
        cos, sin = ctx.saved_tensors
        return rope_qkv_bwd(dq, dk, dv, cos, sin, ctx.dtype), None, None


def rope_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v), each ``[B, S, N, D]``, of the ``[B, S, 3, N, D]`` product
    ``qkv``: q and k rotated by the cos/sin tables (``[S, D]`` or ``[B, S,
    D]``), v as it is; differentiable in qkv. The model calls it where
    ``fused_rope_applies``."""
    return _RopeQKV.apply(qkv, cos, sin)


#: kernel launches since the last reset, added where a kernel is launched
#: and nowhere else (never for the plain versions or an empty batch)
rope_qkv_fwd.launches = 0
rope_qkv_bwd.launches = 0
