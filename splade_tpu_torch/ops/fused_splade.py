"""Fused SPLADE vocabulary projection + masked seq-max (forward).

Counterpart of ``splade_tpu/ops/fused_splade.py::fused_splade_pool``:

    m[b, v]      = max over valid s of ( h[b,s,:] . W[v,:] + bias[v] )
    pooled[b, v] = log1p(relu(m[b, v]))
    token_w[b,s] = log1p(relu(max_v of the same)) * mask[b, s]

Kernel: ``csrc/fused_splade_fwd.cu`` replaces the Pallas ``_fwd_kernel``
(``splade_tpu/ops/fused_splade.py:50``). It is bound by tensor-core
operations (2·B·S·H·V FLOP, 0.64 ms at document encode on an H100) and
keeps each [S, tile] score tile in registers and shared memory, so only
the [B, V] and [B, S] maxima reach device memory; the ragged last vocab
tile is masked in the kernel, so W is never padded or copied. See the
source's note for the design.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs ``fused_splade_pool_plain``. This slice is forward only: the
backward kernels come with the training slice (ROADMAP.md §2, items 2-4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from splade_tpu_torch.ops import _cuda
from splade_tpu_torch.ops.splade_pool import NEG, masked_max_streamed


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
    """The kernel's function in plain PyTorch, f32 products over vocab
    tiles: (m [B, V], pos [B, S]) pre-activation maxima, invalid s -> -1e30."""
    return masked_max_streamed(h, w, bias, mask, tile=8192)


def _launch(h, w, bias, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H = h.shape
    V = w.shape[0]
    if w.shape[1] != H or mask.shape != (B, S):
        raise ValueError(f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"mask {tuple(mask.shape)} do not agree")
    if H % 8:
        raise ValueError(f"hidden size {H} must be a multiple of 8")
    dev = h.device
    # bf16 operands: no copy when they already are (the serving path)
    hb = h.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    for name, t in (("h", hb), ("w", wb)):
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a 16-byte aligned tensor on {dev}")
    maskf = mask.to(device=dev, dtype=torch.float32).contiguous()
    bias_f = (bias.to(device=dev, dtype=torch.float32).contiguous()
              if bias is not None else None)
    m = torch.empty((B, V), dtype=torch.float32, device=dev)
    pos_key = torch.full((B, S), int(float_key(torch.tensor(NEG))),
                         dtype=torch.int32, device=dev)
    if B == 0 or S == 0 or V == 0:
        return torch.full_like(m, NEG), float_from_key(pos_key)
    code = _cuda.library().splade_fused_pool_fwd(
        hb.data_ptr(), wb.data_ptr(),
        bias_f.data_ptr() if bias_f is not None else None,
        maskf.data_ptr(), m.data_ptr(), pos_key.data_ptr(),
        B, S, H, V, _cuda.stream_ptr(hb))
    _cuda.check(code, "splade_fused_pool_fwd")
    fused_splade_pool.launches += 1
    return m, float_from_key(pos_key)


def fused_splade_pool(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [B, V] f32, token_weights [B, S] f32) from h [B, S, H], tied
    decoder w [V, H], bias [V] or None, attention mask [B, S]."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (h, w, bias)):
        raise NotImplementedError(
            "fused_splade_pool is forward-only in this slice: its backward "
            "kernels are the training slice's (ROADMAP.md §2, kernels "
            "#2-#6); call it under torch.no_grad()")
    if h.is_cuda:
        m, pos = _launch(h, w, bias, mask)
    else:
        m, pos = fused_splade_pool_plain(h, w, bias, mask)
    pooled = torch.log1p(torch.relu(m))
    token_weights = (torch.log1p(torch.relu(pos))
                     * mask.to(device=pos.device, dtype=torch.float32))
    return pooled, token_weights


#: kernel launches since the last reset (never counts the plain version)
fused_splade_pool.launches = 0
