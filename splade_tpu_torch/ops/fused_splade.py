"""Fused SPLADE vocabulary projection + masked seq-max, with its gradient.

Counterpart of ``splade_tpu/ops/fused_splade.py::fused_splade_pool`` (a
``jax.custom_vjp``; here a ``torch.autograd.Function``):

    m[b, v]      = max over valid s of ( h[b,s,:] . W[v,:] + bias[v] )
    pooled[b, v] = log1p(relu(m[b, v]))
    token_w[b,s] = log1p(relu(max_v of the same)) * mask[b, s]

Forward kernel: ``csrc/fused_splade_fwd.cu`` replaces the Pallas
``_fwd_kernel`` (``splade_tpu/ops/fused_splade.py:50``). It is bound by
tensor-core operations (2·B·S·H·V FLOP, 0.64 ms at document encode on an
H100) and keeps each [S, tile] score tile in registers and shared memory,
so only the [B, V] and [B, S] maxima reach device memory; the ragged last
vocab tile is masked in the kernel, so W is never padded or copied.

Backward: the forward saves m (the [B, V] maxima), h, w, bias and mask, as
``_fused_fwd`` does. Outside the kernels, as ``_fused_bwd`` does:
``g_pre = g · 1/(1+m)`` where m > 0 else 0, ``dbias = Σ_b g_pre``, and the
token weights' cotangent is ignored (they are monitoring-only). In the
kernels (``csrc/fused_splade_bwd.cu``, replacing ``_bwd_dh_kernel`` at
``fused_splade.py:93`` and ``_bwd_dw_kernel`` at ``:111``): recompute the
score tile, ``G = 1[masked == m] · g_pre``, ``dh = G @ W_tile`` and
``dW = Gᵀ @ h``. Ties get duplicate gradient, as in the Pallas kernels
(autograd through ``amax``, the streamed path's gradient, splits them
instead). dh and dW come back in the dtypes of h and w.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``fused_splade_pool_plain`` and
``fused_splade_bwd_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from splade_tpu_torch.ops import _cuda
from splade_tpu_torch.ops.splade_pool import (NEG, masked_max_streamed,
                                              masked_scores)

#: vocab tile of the plain versions: the forward's maxima and the backward's
#: recompute use the same tile, so the recomputed scores equal m bitwise
PLAIN_TILE = 8192
#: the backward kernels keep one row of f32 sums (up to 768 wide) a thread
MAX_BWD_HIDDEN = 768
#: blocks the dh kernel aims at (a few per multiprocessor of an H100): with
#: fewer (B, 32-row chunk) pairs it splits the vocabulary to get there
DH_TARGET_BLOCKS = 528


def dh_vocab_splits(B: int, S: int, V: int) -> int:
    """How many vocab splits the dh kernel runs (1 at the document batch,
    several at the query batch); their partial sums are added in order."""
    pairs = max(B * -(-S // 32), 1)
    return max(1, min(-(-DH_TARGET_BLOCKS // pairs), -(-V // 128), 16))


def float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 image of f32 values (the kernel's atomicMax
    key): signed-int order of the keys is float order of the values."""
    i = x.to(torch.float32).view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def float_from_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def fused_splade_pool_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch, f32 products over
    vocab tiles: (m [B, V], pos [B, S]) pre-activation maxima, invalid
    s -> -1e30."""
    return masked_max_streamed(h, w, bias, mask, tile=PLAIN_TILE)


def fused_splade_bwd_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, m: torch.Tensor, g_pre: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch: recompute each
    score tile as ``fused_splade_pool_plain`` computed it, ``G =
    1[masked == m] · g_pre``, ``dh = G @ W_tile``, ``dw = Gᵀ @ h``.
    Returns (dh [B, S, H] f32, dw [V, H] f32)."""
    B, S, H = h.shape
    V = w.shape[0]
    with torch.autocast(h.device.type, enabled=False):
        x = h.to(torch.float32)
        valid = mask.to(torch.bool)[:, :, None]
        dh = torch.zeros((B, S, H), dtype=torch.float32, device=h.device)
        dw = torch.empty((V, H), dtype=torch.float32, device=h.device)
        for v0 in range(0, V, PLAIN_TILE):
            masked = masked_scores(x, w, bias, valid, v0, PLAIN_TILE)
            cols = slice(v0, v0 + PLAIN_TILE)
            G = torch.where(masked == m[:, None, cols],
                            g_pre[:, None, cols].to(torch.float32), 0.0)
            dh += G @ w[cols].to(torch.float32)
            dw[cols] = torch.einsum("bsv,bsh->vh", G, x)
    return dh, dw


def _operands(h, w, bias, mask):
    """bf16 h and w (no copy when they already are), f32 mask and bias, on
    h's device, checked for what the kernels take."""
    B, S, H = h.shape
    if w.dim() != 2 or w.shape[1] != H or mask.shape != (B, S):
        raise ValueError(f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"mask {tuple(mask.shape)} do not agree")
    if H % 8:
        raise ValueError(f"hidden size {H} must be a multiple of 8")
    dev = h.device
    hb = h.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    for name, t in (("h", hb), ("w", wb)):
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a 16-byte aligned tensor on {dev}")
    maskf = mask.to(device=dev, dtype=torch.float32).contiguous()
    bias_f = (bias.to(device=dev, dtype=torch.float32).contiguous()
              if bias is not None else None)
    return hb, wb, bias_f, maskf


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """What differs between the pool's kernel families: the per-row one of
    this module and the row-blocked one of ``ops/fused_splade_v2.py``. The
    launchers and the ``autograd.Function`` below serve both, so operand
    preparation, the empty batch, the ordered sum of the dh splits and the
    tie, dbias and autocast rules are written once."""

    #: the C entries are <prefix>_fwd, <prefix>_bwd_dh and <prefix>_bwd_dw
    prefix: str
    #: (hb, row_block, backward) -> the ints the C entries take after V;
    #: raises ValueError for what the kernels cannot take
    block_args: Callable
    #: (B, S, V, *block_args) -> vocab splits of the dh kernel
    dh_splits: Callable
    #: the plain versions, taking row_block as their last argument
    plain_fwd: Callable
    plain_bwd: Callable
    #: "fwd" / "dh" / "dw" -> the public function whose ``launches`` counts
    #: that kernel, filled in where those functions are defined
    counted: Dict[str, Callable] = dataclasses.field(default_factory=dict)


def _launch_fwd(fam: KernelFamily, h, w, bias, mask, row_block
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    hb, wb, bias_f, maskf = _operands(h, w, bias, mask)
    B, S, H = hb.shape
    V = wb.shape[0]
    extra = fam.block_args(hb, row_block, False)
    dev = hb.device
    m = torch.empty((B, V), dtype=torch.float32, device=dev)
    pos_key = torch.full((B, S), int(float_key(torch.tensor(NEG))),
                         dtype=torch.int32, device=dev)
    if B == 0 or S == 0 or V == 0:
        return torch.full_like(m, NEG), float_from_key(pos_key)
    entry = fam.prefix + "_fwd"
    code = getattr(_cuda.library(), entry)(
        hb.data_ptr(), wb.data_ptr(),
        bias_f.data_ptr() if bias_f is not None else None,
        maskf.data_ptr(), m.data_ptr(), pos_key.data_ptr(),
        B, S, H, V, *extra, _cuda.stream_ptr(hb))
    _cuda.check(code, entry)
    fam.counted["fwd"].launches += 1
    return m, float_from_key(pos_key)


def _launch_bwd(fam: KernelFamily, which: str, h, w, bias, mask, m, g_pre,
                row_block) -> torch.Tensor:
    """One backward kernel, ``which`` "dh" (out [B,S,H]) or "dw" (out
    [V,H]), f32. The output starts at 0: the row-blocked kernels add into
    it."""
    hb, wb, bias_f, maskf = _operands(h, w, bias, mask)
    B, S, H = hb.shape
    V = wb.shape[0]
    extra = fam.block_args(hb, row_block, True)
    dev = hb.device
    m32 = m.to(device=dev, dtype=torch.float32).contiguous()
    g32 = g_pre.to(device=dev, dtype=torch.float32).contiguous()
    if m32.shape != (B, V) or g32.shape != (B, V):
        raise ValueError(f"m {tuple(m.shape)} and g_pre {tuple(g_pre.shape)} "
                         f"must be [{B}, {V}]")
    is_dh = which == "dh"
    splits = fam.dh_splits(B, S, V, *extra) if is_dh else 1
    out = torch.zeros(((splits, B, S, H) if is_dh else (V, H)),
                      dtype=torch.float32, device=dev)
    if B == 0 or S == 0 or V == 0:
        return out.sum(0) if is_dh else out
    entry = f"{fam.prefix}_bwd_{which}"
    code = getattr(_cuda.library(), entry)(
        hb.data_ptr(), wb.data_ptr(),
        bias_f.data_ptr() if bias_f is not None else None,
        maskf.data_ptr(), m32.data_ptr(), g32.data_ptr(), out.data_ptr(),
        B, S, H, V, *extra, *([splits] if is_dh else []),
        _cuda.stream_ptr(hb))
    _cuda.check(code, entry)
    fam.counted[which].launches += 1
    if is_dh:  # the splits' partial sums, added in a fixed order
        return out[0] if splits == 1 else out.sum(0)
    return out


def family_maxima(fam: KernelFamily, h, w, bias, mask, row_block=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m [B, V], pos [B, S]): the family's forward kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    if h.is_cuda:
        return _launch_fwd(fam, h, w, bias, mask, row_block)
    return fam.plain_fwd(h, w, bias, mask, row_block)


def family_bwd(fam: KernelFamily, which: str, h, w, bias, mask, m, g_pre,
               row_block=None) -> torch.Tensor:
    """dh [B, S, H] or dW [V, H] f32: the family's kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    if h.is_cuda:
        return _launch_bwd(fam, which, h, w, bias, mask, m, g_pre, row_block)
    return fam.plain_bwd(h, w, bias, mask, m, g_pre,
                         row_block)[("dh", "dw").index(which)]


def fold_cotangent(g_pooled: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """g_pre = g · d log1p(relu(m)) / dm = g / (1 + m) where m > 0, else 0."""
    m = m.to(torch.float32)
    return g_pooled.to(torch.float32) * torch.where(
        m > 0, 1.0 / (1.0 + m), torch.zeros_like(m))


class _FusedPool(torch.autograd.Function):
    """Counterpart of the ``jax.custom_vjp``s (``fused_splade.py:173-222``,
    ``fused_splade_v2.py:126-215``) over one kernel family.
    ``custom_fwd``/``custom_bwd`` run the backward under the forward's
    autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, h, w, bias, mask, fam, row_block):
        m, pos = family_maxima(fam, h, w, bias, mask, row_block)
        ctx.save_for_backward(h, w, bias, mask, m)
        ctx.family = fam, row_block
        pooled = torch.log1p(torch.relu(m))
        token_weights = (torch.log1p(torch.relu(pos))
                         * mask.to(device=pos.device, dtype=torch.float32))
        ctx.mark_non_differentiable(token_weights)
        return pooled, token_weights

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g_pooled, _g_token_weights):
        h, w, bias, mask, m = ctx.saved_tensors
        fam, rb = ctx.family
        g_pre = fold_cotangent(g_pooled, m)
        dh = dw = dbias = None
        if h.is_cuda:
            if ctx.needs_input_grad[0]:
                dh = family_bwd(fam, "dh", h, w, bias, mask, m, g_pre, rb)
            if ctx.needs_input_grad[1]:
                dw = family_bwd(fam, "dw", h, w, bias, mask, m, g_pre, rb)
        elif ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dh, dw = fam.plain_bwd(h, w, bias, mask, m, g_pre, rb)
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = g_pre.sum(0).to(bias.dtype)
        return (dh.to(h.dtype) if ctx.needs_input_grad[0] else None,
                dw.to(w.dtype) if ctx.needs_input_grad[1] else None,
                dbias, None, None, None)


def family_pool(fam: KernelFamily, h, w, bias, mask, row_block=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, token_weights) through the family's kernels, differentiable
    in h, w and bias."""
    return _FusedPool.apply(h, w, bias, mask, fam, row_block)


def _per_row_args(hb, _row_block, backward: bool) -> list:
    if backward and hb.shape[-1] > MAX_BWD_HIDDEN:
        raise ValueError(f"hidden size {hb.shape[-1]} > {MAX_BWD_HIDDEN}: the "
                         "backward kernels keep one row of sums per thread")
    return []


# the plain versions are looked up when called, not when the family is made
PER_ROW = KernelFamily(
    prefix="splade_fused_pool", block_args=_per_row_args,
    dh_splits=dh_vocab_splits,
    plain_fwd=lambda h, w, bias, mask, _rb: fused_splade_pool_plain(
        h, w, bias, mask),
    plain_bwd=lambda h, w, bias, mask, m, g_pre, _rb: fused_splade_bwd_plain(
        h, w, bias, mask, m, g_pre))


def fused_splade_maxima(h, w, bias, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m [B, V], pos [B, S]) pre-activation maxima: the forward kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    return family_maxima(PER_ROW, h, w, bias, mask)


def fused_splade_bwd_dh(h, w, bias, mask, m, g_pre) -> torch.Tensor:
    """dh [B, S, H] f32 of the pool: the dh kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    return family_bwd(PER_ROW, "dh", h, w, bias, mask, m, g_pre)


def fused_splade_bwd_dw(h, w, bias, mask, m, g_pre) -> torch.Tensor:
    """dW [V, H] f32 of the pool: the dW kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    return family_bwd(PER_ROW, "dw", h, w, bias, mask, m, g_pre)


def fused_splade_pool(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [B, V] f32, token_weights [B, S] f32) from h [B, S, H], tied
    decoder w [V, H], bias [V] or None, attention mask [B, S]. Differentiable
    in h, w and bias; token_weights carries no gradient."""
    return family_pool(PER_ROW, h, w, bias, mask)


#: kernel launches since the last reset, added where a kernel is launched
#: and nowhere else (never for the plain versions or an empty batch)
fused_splade_pool.launches = 0
fused_splade_bwd_dh.launches = 0
fused_splade_bwd_dw.launches = 0
PER_ROW.counted.update(fwd=fused_splade_pool, dh=fused_splade_bwd_dh,
                       dw=fused_splade_bwd_dw)
