"""Sliding-window + segment-id flash attention, with its gradient.

Counterpart of ``splade_tpu/models/modernbert.py::_splash_attention`` (JAX's
Pallas splash multi-head attention with its flash-style VJP, reached when
``attention_impl="splash"``); here a ``torch.autograd.Function`` over three
hand-written Hopper kernels. With q, k, v ``[B, N, S, D]`` (RoPE applied),
``seg`` ``[B, S]`` and ``half_window``:

    s[b,n,i,j]   = q[b,n,i,:] . k[b,n,j,:] / sqrt(D)
    allowed(i,j) = seg[b,i] == seg[b,j] and (half_window == 0
                                             or |i - j| <= half_window)
    out[b,i,n,:] = softmax_j( s over allowed j ) . v[b,n,j,:]
    lse[b,n,i]   = log sum_j exp(s) over allowed j

``half_window == 0`` is full attention (the global layers). Padding and
packing both ride ``seg`` (``segment_ids_with_padding``): a padded token's
id is its packing segment + 1,000,000, so real tokens never see padding and
padded tokens see each other; every token sees itself, so no row is empty.
At padded positions the output therefore differs from the additive-mask
(sdpa) route's by design; at valid positions only rounding differs.

Kernels (``csrc/splash_attention_fwd.cu``, ``csrc/splash_attention_bwd.cu``,
shared pieces, the mask's two tests among them, in
``csrc/splash_attention.cuh``, and the generic register-level ones in
``csrc/mma_sm90.cuh``): the forward owns one (b, head, 64-query
tile) a block and walks the kv tiles its mask can reach with an online
softmax in f32, the scores, p and the output in ``mma.sync`` fragments in
registers and the K/V tiles double-buffered with ``cp.async``; it writes
``lse`` as a natural log. The backward is two kernels launched in order on
one stream. The dq kernel (a block owns a query tile) first computes
``delta = rowsum(dO * out)`` in f32 for its rows and writes it ``[B, N,
S]``; the dk/dv kernel (a block owns a kv tile) reads it. Both recompute
``p = exp(s - lse)`` and ``ds = p * (dp - delta)`` in registers (bf16
``mma.sync`` with f32 sums; the walked tiles double-buffered with
``cp.async``). When q needs no gradient the dq kernel still launches: it
supplies delta, and stops there. The ``[B, N, S, S]`` scores reach device
memory in neither direction, local layers skip every tile wholly outside
the band, and each sum has one owner and one order (no atomics), so a
repeated backward is bitwise equal. The backward writes each gradient in
the dtype autograd returns for its operand (bf16 for a bf16 operand, else
f32), rounded to nearest from its f32 sums as a cast would round them.
Products run in bf16 on the tensor cores with f32 sums; ``p`` and ``ds``
are rounded to bf16 before the second products, as the TPU kernel rounds
them to v's dtype; the f32 scores are scaled inside the kernels (JAX
pre-multiplies q by the scale in bf16).

The kernels read q, k and v through their strides (any layout whose last
dimension is contiguous with 16-byte aligned rows: the ``[B, N, S, D]``
views of a ``[B, S, N, D]`` or fused-QKV tensor are taken as they are, with
no copy); operands that are not bf16 are cast once per call. They take
every S (the ragged last tile is masked) and D = 64; another D raises
``ValueError`` on a CUDA tensor.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``splash_attention_plain`` and
``splash_attention_bwd_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from splade_tpu_torch.ops import _cuda

#: rows of a query tile and of a kv tile, in the kernels and the plain versions
TILE = 64
#: the head width the kernels are built for
KERNEL_HEAD_DIM = 64
#: finite stand-in for -inf: the running maximum's start and a masked score
NEG = -1e30
#: added to the packing segment of a padded token
PAD_SEGMENT_OFFSET = 1_000_000


def segment_ids_with_padding(attention_mask: torch.Tensor,
                             segment_ids: torch.Tensor = None) -> torch.Tensor:
    """[B, S] int32 segment ids that carry padding too: a padded token's id
    is its packing segment (0 without packing) + 1,000,000, so it matches no
    real token, and padded tokens of one segment match each other (their
    softmax rows stay finite; pooling and the MLM loss discard them)."""
    base = (torch.zeros_like(attention_mask) if segment_ids is None
            else segment_ids)
    return torch.where(attention_mask.to(torch.bool), base,
                       base + PAD_SEGMENT_OFFSET).to(torch.int32)


def tile_range(t0: int, S: int, half_window: int) -> range:
    """Tiles of the other axis that the tile starting at row ``t0`` can
    reach: all of them without a window, else those that touch the band."""
    last = (S - 1) // TILE
    if half_window == 0:
        return range(0, last + 1)
    end = min(t0 + TILE, S) - 1
    return range(max(t0 - half_window, 0) // TILE,
                 min(end + half_window, S - 1) // TILE + 1)


def _allowed(seg: torch.Tensor, q0: int, k0: int, half_window: int
             ) -> torch.Tensor:
    """[B, 1, tq, tk] bool mask of the (query tile at q0, kv tile at k0)."""
    sq, sk = seg[:, q0:q0 + TILE], seg[:, k0:k0 + TILE]
    ok = sq[:, :, None] == sk[:, None, :]
    if half_window > 0:
        qi = torch.arange(q0, q0 + sq.shape[1], device=seg.device)
        kj = torch.arange(k0, k0 + sk.shape[1], device=seg.device)
        ok = ok & ((qi[:, None] - kj[None, :]).abs() <= half_window)
    return ok[:, None]


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x (f32) with the values it keeps as ``dtype``, back in f32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def splash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seg: torch.Tensor, half_window: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch, tile by tile with
    the online softmax as the kernel walks it, f32 arithmetic on the
    operands' values with p rounded to v's dtype before p . v. Returns
    (out [B, S, N, D] f32, lse [B, N, S] f32)."""
    B, N, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty((B, N, S, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=dev)
    with torch.autocast(dev.type, enabled=False):
        qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
        for q0 in range(0, S, TILE):
            qt = qf[:, :, q0:q0 + TILE]
            m = torch.full(qt.shape[:3], NEG, dtype=torch.float32, device=dev)
            l = torch.zeros_like(m)
            o = torch.zeros_like(qt)
            for t in tile_range(q0, S, half_window):
                k0 = t * TILE
                ok = _allowed(seg, q0, k0, half_window)
                s = (qt @ kf[:, :, k0:k0 + TILE].transpose(-1, -2)) * scale
                s = torch.where(ok, s, torch.full_like(s, NEG))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.where(ok, torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + _rounded(p, v.dtype) @ vf[
                    :, :, k0:k0 + TILE]
                m = m_new
            out[:, :, q0:q0 + TILE] = o / l[..., None]
            lse[:, :, q0:q0 + TILE] = m + torch.log(l)
    return out.transpose(1, 2), lse


def splash_attention_delta(d_out: torch.Tensor, out: torch.Tensor
                           ) -> torch.Tensor:
    """delta[b, n, i] = sum_d dO[b,i,n,d] * out[b,i,n,d] in f32, [B, N, S]:
    what the backward kernels subtract from dp."""
    return (d_out.to(torch.float32) * out.to(torch.float32)).sum(-1).transpose(
        1, 2).contiguous()


def splash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor,
    half_window: int, d_out: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch, tile by tile:
    ``p = exp(s - lse)`` on the allowed pairs, ``dp = dO . vᵀ``, ``ds = p *
    (dp - delta)``, then ``dq = ds . k``, ``dk = dsᵀ . q`` (both times the
    scale) and ``dv = pᵀ . dO``, with p and ds rounded to v's dtype before
    those products. d_out is [B, S, N, D]; returns (dq, dk, dv), each
    [B, S, N, D] f32."""
    B, N, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    with torch.autocast(dev.type, enabled=False):
        qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
        do = d_out.to(torch.float32).transpose(1, 2)          # [B, N, S, D]
        dq, dk, dv = (torch.zeros((B, N, S, D), dtype=torch.float32,
                                  device=dev) for _ in range(3))
        for q0 in range(0, S, TILE):
            rows = slice(q0, q0 + TILE)
            for t in tile_range(q0, S, half_window):
                k0 = t * TILE
                cols = slice(k0, k0 + TILE)
                ok = _allowed(seg, q0, k0, half_window)
                s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
                p = torch.where(ok, torch.exp(s - lse[:, :, rows, None]),
                                torch.zeros_like(s))
                dp = do[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
                ds = _rounded(p * (dp - delta[:, :, rows, None]), v.dtype)
                dq[:, :, rows] += ds @ kf[:, :, cols]
                dk[:, :, cols] += ds.transpose(-1, -2) @ qf[:, :, rows]
                dv[:, :, cols] += _rounded(p, v.dtype).transpose(
                    -1, -2) @ do[:, :, rows]
    return ((dq * scale).transpose(1, 2), (dk * scale).transpose(1, 2),
            dv.transpose(1, 2))


def _operand(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` as a bf16 tensor the kernels can read through its strides (no
    copy when it already is one), checked for what they take."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(t.shape)} must be {tuple(shape)}")
    t = t.to(torch.bfloat16)
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t


def _operands(q, k, v, seg):
    if q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be [B, N, S, D]")
    B, N, S, D = q.shape
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {D}: the splash attention kernels are "
                         f"built for D = {KERNEL_HEAD_DIM}")
    dev = q.device
    ops = [_operand(name, t, q.shape)
           for name, t in (("q", q), ("k", k), ("v", v))]
    if any(t.device != dev for t in ops):
        raise ValueError(f"q, k and v must all lie on {dev}")
    if tuple(seg.shape) != (B, S):
        raise ValueError(f"seg {tuple(seg.shape)} must be [{B}, {S}]")
    segi = seg.to(device=dev, dtype=torch.int32).contiguous()
    return (*ops, segi)


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride()[:3]  # elements between batch rows, heads, positions


def _per_head(name: str, t: torch.Tensor, B: int, N: int, S: int
              ) -> torch.Tensor:
    t = t.to(torch.float32).contiguous()
    if tuple(t.shape) != (B, N, S):
        raise ValueError(f"{name} {tuple(t.shape)} must be [{B}, {N}, {S}]")
    return t


def _launch_fwd(q, k, v, seg, half_window: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    qb, kb, vb, segi = _operands(q, k, v, seg)
    B, N, S, D = qb.shape
    out = torch.empty((B, S, N, D), dtype=torch.bfloat16, device=qb.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=qb.device)
    if B == 0 or N == 0 or S == 0:
        return out, lse
    entry = "splade_splash_attn_fwd"
    code = getattr(_cuda.library(), entry)(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), segi.data_ptr(),
        out.data_ptr(), lse.data_ptr(), *_strides(qb), *_strides(kb),
        *_strides(vb), B, N, S, D, int(half_window), 1.0 / math.sqrt(D),
        _cuda.stream_ptr(qb))
    _cuda.check(code, entry)
    splash_attention.launches += 1
    return out, lse


def _grad_dtype(dtype: torch.dtype) -> torch.dtype:
    """What the backward kernels write for an operand of ``dtype``: bf16 for
    bf16, f32 for any other (autograd's cast then makes it ``dtype``)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _bwd_inputs(q, k, v, seg, d_out):
    qb, kb, vb, segi = _operands(q, k, v, seg)
    B, N, S, D = qb.shape
    if tuple(d_out.shape) != (B, S, N, D):
        raise ValueError(f"dO {tuple(d_out.shape)} must be [{B}, {S}, {N}, "
                         f"{D}]")
    return qb, kb, vb, segi, d_out.to(torch.bfloat16).contiguous()


def _launch_bwd_dq(q, k, v, seg, half_window: int, d_out, out, lse,
                   dq_dtype):
    """The dq kernel: (dq [B, S, N, D] in ``dq_dtype``, or None when
    ``dq_dtype`` is None and the kernel computes delta alone; delta [B, N,
    S] f32), every element written once."""
    qb, kb, vb, segi, dob = _bwd_inputs(q, k, v, seg, d_out)
    B, N, S, D = qb.shape
    if tuple(out.shape) != (B, S, N, D):
        raise ValueError(f"out {tuple(out.shape)} must be [{B}, {S}, {N}, "
                         f"{D}]")
    outb = out.to(torch.bfloat16).contiguous()
    lse32 = _per_head("lse", lse, B, N, S)
    delta = torch.empty((B, N, S), dtype=torch.float32, device=qb.device)
    dq = (None if dq_dtype is None else
          torch.empty((B, S, N, D), dtype=_grad_dtype(dq_dtype),
                      device=qb.device))
    if not (B == 0 or N == 0 or S == 0):
        entry = "splade_splash_attn_bwd_dq"
        code = getattr(_cuda.library(), entry)(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), segi.data_ptr(),
            dob.data_ptr(), outb.data_ptr(), lse32.data_ptr(),
            delta.data_ptr(), 0 if dq is None else dq.data_ptr(),
            int(dq is not None and dq.dtype == torch.bfloat16),
            *_strides(qb), *_strides(kb), *_strides(vb), B, N, S, D,
            int(half_window), 1.0 / math.sqrt(D), _cuda.stream_ptr(qb))
        _cuda.check(code, entry)
        splash_attention_bwd_dq.launches += 1
    return dq, delta


def _launch_bwd_dkv(q, k, v, seg, half_window: int, d_out, lse, delta,
                    dk_dtype, dv_dtype):
    """The dk/dv kernel, fed the dq kernel's delta: (dk, dv), each [B, S,
    N, D] in ``dk_dtype`` / ``dv_dtype``, every element written once."""
    qb, kb, vb, segi, dob = _bwd_inputs(q, k, v, seg, d_out)
    B, N, S, D = qb.shape
    lse32 = _per_head("lse", lse, B, N, S)
    delta32 = _per_head("delta", delta, B, N, S)
    dk, dv = (torch.empty((B, S, N, D), dtype=_grad_dtype(dt),
                          device=qb.device) for dt in (dk_dtype, dv_dtype))
    if not (B == 0 or N == 0 or S == 0):
        entry = "splade_splash_attn_bwd_dkv"
        code = getattr(_cuda.library(), entry)(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), segi.data_ptr(),
            dob.data_ptr(), lse32.data_ptr(), delta32.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), int(dk.dtype == torch.bfloat16),
            int(dv.dtype == torch.bfloat16), *_strides(qb), *_strides(kb),
            *_strides(vb), B, N, S, D, int(half_window), 1.0 / math.sqrt(D),
            _cuda.stream_ptr(qb))
        _cuda.check(code, entry)
        splash_attention_bwd_dkv.launches += 1
    return dk, dv


def splash_attention_forward(q, k, v, seg, half_window: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, S, N, D], lse [B, N, S] f32): the forward kernel on CUDA
    tensors (out in bf16), its plain version on CPU tensors (out in f32)."""
    if q.is_cuda:
        return _launch_fwd(q, k, v, seg, half_window)
    return splash_attention_plain(q, k, v, seg, half_window)


def splash_attention_bwd_dq(q, k, v, seg, half_window: int, d_out, out, lse,
                            dq_dtype=torch.float32):
    """(dq [B, S, N, D], delta [B, N, S] f32) from the forward's out and
    lse: on CUDA tensors the dq kernel, which computes delta itself (dq in
    bf16 for ``dq_dtype`` bf16, else f32; ``dq_dtype`` None: delta alone,
    dq None); on CPU tensors ``splash_attention_delta`` and the plain
    backward (dq in ``dq_dtype``)."""
    if q.is_cuda:
        return _launch_bwd_dq(q, k, v, seg, half_window, d_out, out, lse,
                              dq_dtype)
    delta = splash_attention_delta(d_out, out)
    dq = (None if dq_dtype is None else splash_attention_bwd_plain(
        q, k, v, seg, half_window, d_out, lse, delta)[0].to(dq_dtype))
    return dq, delta


def splash_attention_bwd_dkv(q, k, v, seg, half_window: int, d_out, lse,
                             delta, dk_dtype=torch.float32,
                             dv_dtype=torch.float32
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each [B, S, N, D], from the delta that
    ``splash_attention_bwd_dq`` returned: the dk/dv kernel on CUDA tensors
    (each in bf16 for a bf16 dtype, else f32), the plain backward on CPU
    tensors (in the dtypes asked)."""
    if q.is_cuda:
        return _launch_bwd_dkv(q, k, v, seg, half_window, d_out, lse, delta,
                               dk_dtype, dv_dtype)
    _, dk, dv = splash_attention_bwd_plain(q, k, v, seg, half_window, d_out,
                                           lse, delta)
    return dk.to(dk_dtype), dv.to(dv_dtype)


class _SplashAttention(torch.autograd.Function):
    """Counterpart of the custom VJP inside JAX's splash kernel: the forward
    saves its own out and lse, the backward recomputes p from them.
    ``custom_fwd``/``custom_bwd`` run the backward under the forward's
    autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, seg, half_window):
        ctx.dtypes = q.dtype, k.dtype, v.dtype
        if q.is_cuda:  # cast once: the backward reads the same bf16 operands
            q, k, v, seg = _operands(q, k, v, seg)
        out, lse = splash_attention_forward(q, k, v, seg, half_window)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.half_window = half_window
        return out.to(ctx.dtypes[0])

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, d_out):
        q, k, v, seg, out, lse = ctx.saved_tensors
        hw = ctx.half_window
        d_out = d_out.to(out.dtype).contiguous()  # as the kernels read it
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq = dk = dv = None
        if q.is_cuda:
            # the dq kernel supplies delta, so it runs even when q needs no
            # gradient; the gradients come out in the dtypes returned below
            dq, delta = splash_attention_bwd_dq(
                q, k, v, seg, hw, d_out, out, lse,
                ctx.dtypes[0] if need_q else None)
            if need_k or need_v:
                dk, dv = splash_attention_bwd_dkv(
                    q, k, v, seg, hw, d_out, lse, delta, *ctx.dtypes[1:])
        elif need_q or need_k or need_v:
            dq, dk, dv = splash_attention_bwd_plain(
                q, k, v, seg, hw, d_out, lse,
                splash_attention_delta(d_out, out))
        # [B, S, N, D] -> the operands' [B, N, S, D] views, in their dtypes
        return tuple(
            g.transpose(1, 2).to(dtype) if need else None
            for g, dtype, need in zip((dq, dk, dv), ctx.dtypes,
                                      (need_q, need_k, need_v))) + (None, None)


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     seg: torch.Tensor, half_window: int) -> torch.Tensor:
    """Windowed, segmented softmax attention of q, k, v [B, N, S, D] (RoPE
    applied) with seg [B, S]; ``half_window`` 0 = full attention. Returns
    [B, S, N, D] in q's dtype, differentiable in q, k and v."""
    return _SplashAttention.apply(q, k, v, seg, int(half_window))


#: kernel launches since the last reset, added where a kernel is launched
#: and nowhere else (never for the plain versions or an empty batch)
splash_attention.launches = 0
splash_attention_bwd_dq.launches = 0
splash_attention_bwd_dkv.launches = 0
