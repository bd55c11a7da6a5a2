"""Row-blocked variant of the fused SPLADE pool, with its gradient.

Counterpart of ``splade_tpu/ops/fused_splade_v2.py::fused_splade_pool_v2``
(a ``jax.custom_vjp``; here a ``torch.autograd.Function``). The function is
``ops/fused_splade.py``'s:

    m[b, v]      = max over valid s of ( h[b,s,:] . W[v,:] + bias[v] )
    pooled[b, v] = log1p(relu(m[b, v]))
    token_w[b,s] = log1p(relu(max_v of the same)) * mask[b, s]

with ``row_block`` batch rows handled together: one product
``[row_block·S, H] × [H, tile]`` per (row block, vocab tile). On the TPU
that amortises the weight tile's residency over more rows; on the H100 the
kernels (``csrc/fused_splade_v2_fwd.cu`` replacing ``_fwd_kernel`` at
``fused_splade_v2.py:46``, ``csrc/fused_splade_v2_bwd.cu`` replacing
``_bwd_dh_kernel`` at ``:65`` and ``_bwd_dw_kernel`` at ``:87``) keep the W
tile in shared memory across the row block's rows, where the per-row family
re-stages it for every chunk. Every score goes through
``csrc/fused_splade_tile.cuh``, so this family's ``m`` equals the per-row
family's bit for bit and either backward may recompute either forward.

``row_block=0`` picks the largest of 8, 4, 2, 1 that divides B; a
``row_block`` that does not divide B raises ``ValueError``. (The JAX
function's "8 or the whole batch" rule is a tiling constraint of the TPU's
compiler and does not carry over.) The gradient rules are
``fused_splade_pool``'s: token weights carry no gradient, ``g_pre`` and
``dbias`` are computed outside the kernels, ties get duplicate gradient, dh
and dW come back in the dtypes of h and w.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``fused_splade_pool_v2_plain`` and
``fused_splade_bwd_v2_plain``. There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from splade_tpu_torch.ops import _cuda
from splade_tpu_torch.ops.fused_splade import (PLAIN_TILE, KernelFamily,
                                               family_bwd, family_maxima,
                                               family_pool, launch_recompute)
from splade_tpu_torch.ops.splade_pool import NEG

#: vocab columns of the kernels' resident W tile
TILE_COLS = 64
#: dynamic shared memory one block may opt into on an H100
MAX_SHARED_BYTES = 232_448
#: blocks the dh kernel aims at: one per multiprocessor (the resident tile
#: leaves room for one); with fewer row blocks it splits the vocabulary
DH_TARGET_BLOCKS = 132


def pick_row_block(B: int) -> int:
    """The largest of 8, 4, 2, 1 that divides B."""
    return next(rb for rb in (8, 4, 2, 1) if B % rb == 0)


def resolve_row_block(B: int, row_block: int) -> int:
    if row_block < 0 or (row_block and B % row_block):
        # a block that does not divide B would leave the tail rows
        # uncomputed (no output, dropped gradients): refuse instead
        raise ValueError(
            f"row_block={row_block} must divide batch {B} "
            "(or pass 0 to pick a dividing block automatically)")
    return row_block or pick_row_block(B)


def shared_bytes(H: int, row_block: int) -> int:
    """Dynamic shared memory of the family's largest kernel at hidden width
    H: the resident W tile, the staged chunk and the row block's vectors.
    A mirror of the ``shared_bytes`` functions in the two ``.cu`` files,
    which the launch path asks instead (``_check``); a test on the card
    holds this mirror equal to them."""
    ld = -(-H // 64) * 64 + 8
    w_tile = -(-TILE_COLS * ld * 2 // 128) * 128
    fwd = w_tile + 34_816 + 256 + row_block * 256
    bwd = w_tile + 17_408 + 256 + 2 * row_block * 256 + 512
    return max(fwd, bwd)


def dh_vocab_splits_v2(B: int, row_block: int, V: int) -> int:
    """How many vocab splits the dh kernel runs so that B // row_block row
    blocks fill the card; their partial sums are added in order."""
    blocks = max(B // max(row_block, 1), 1)
    return max(1, min(-(-DH_TARGET_BLOCKS // blocks), -(-V // TILE_COLS), 16))


def _row_block_scores(xf, w, bias, valid, v0):
    """[RB·S, tile] f32 scores of one row block's flattened rows against
    vocab columns v0..v0+PLAIN_TILE, invalid rows -1e30: the one expression
    the plain forward and the plain backward both evaluate."""
    logits = xf @ w[v0:v0 + PLAIN_TILE].to(torch.float32).T
    if bias is not None:
        logits = logits + bias[v0:v0 + PLAIN_TILE].to(torch.float32)
    return torch.where(valid, logits, torch.full_like(logits, NEG))


def fused_splade_pool_v2_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, row_block: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch, row block by row
    block as the kernel walks it: (m [B, V], pos [B, S]) pre-activation
    maxima in f32, invalid s -> -1e30."""
    B, S, H = h.shape
    V = w.shape[0]
    RB = resolve_row_block(B, row_block)
    dev = h.device
    m = torch.full((B, V), NEG, dtype=torch.float32, device=dev)
    pos = torch.full((B, S), NEG, dtype=torch.float32, device=dev)
    with torch.autocast(dev.type, enabled=False):
        x = h.to(torch.float32)
        valid = mask.to(device=dev).to(torch.bool)
        for b0 in range(0, B, RB):
            xf = x[b0:b0 + RB].reshape(RB * S, H)
            vf = valid[b0:b0 + RB].reshape(RB * S, 1)
            for v0 in range(0, V, PLAIN_TILE):
                masked = _row_block_scores(xf, w, bias, vf, v0)
                masked = masked.view(RB, S, -1)
                m[b0:b0 + RB, v0:v0 + PLAIN_TILE] = masked.amax(1)
                pos[b0:b0 + RB] = torch.maximum(pos[b0:b0 + RB],
                                                masked.amax(2))
    return m, pos


def fused_splade_bwd_v2_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, m: torch.Tensor, g_pre: torch.Tensor,
    row_block: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch: per row block,
    recompute the scores as ``fused_splade_pool_v2_plain`` computed them,
    ``G = 1[masked == m] · g_pre`` with m and g_pre looked up by each
    flattened row's own b, ``dh = G @ W_tile`` summed over vocab tiles,
    ``dw = Gᵀ @ h`` summed over row blocks.
    Returns (dh [B, S, H] f32, dw [V, H] f32)."""
    B, S, H = h.shape
    V = w.shape[0]
    RB = resolve_row_block(B, row_block)
    dev = h.device
    dh = torch.zeros((B, S, H), dtype=torch.float32, device=dev)
    dw = torch.zeros((V, H), dtype=torch.float32, device=dev)
    with torch.autocast(dev.type, enabled=False):
        x = h.to(torch.float32)
        valid = mask.to(device=dev).to(torch.bool)
        g32 = g_pre.to(torch.float32)
        for b0 in range(0, B, RB):
            xf = x[b0:b0 + RB].reshape(RB * S, H)
            vf = valid[b0:b0 + RB].reshape(RB * S, 1)
            for v0 in range(0, V, PLAIN_TILE):
                cols = slice(v0, v0 + PLAIN_TILE)
                masked = _row_block_scores(xf, w, bias, vf, v0)
                # each flattened row's own b: [RB, T] -> [RB·S, T]
                m_rows = m[b0:b0 + RB, cols].repeat_interleave(S, dim=0)
                g_rows = g32[b0:b0 + RB, cols].repeat_interleave(S, dim=0)
                G = torch.where(masked == m_rows, g_rows, 0.0)
                dh[b0:b0 + RB] += (G @ w[cols].to(torch.float32)).view(
                    RB, S, H)
                dw[cols] += G.T @ xf
    return dh, dw


def _check(h, row_block: int) -> int:
    """The row block the kernels run at, refused where their shared memory
    would not fit. For a CUDA tensor the size is the built kernels' own
    (their C entries report it); ``shared_bytes`` stands in on the CPU."""
    B, _, H = h.shape
    RB = resolve_row_block(B, row_block)
    if h.is_cuda:
        lib = _cuda.library()
        need = max(lib.splade_fused_pool_v2_fwd_shared_bytes(H, RB),
                   lib.splade_fused_pool_v2_bwd_shared_bytes(H, RB))
    else:
        need = shared_bytes(H, RB)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"hidden size {H} with row_block {RB} needs {need} bytes of "
            f"shared memory a block (at most {MAX_SHARED_BYTES}): the "
            "kernels keep a 64-row W tile resident")
    return RB


# the plain versions are looked up when called, not when the family is made
ROW_BLOCKED = KernelFamily(
    prefix="splade_fused_pool_v2",
    block_args=lambda hb, row_block, _backward: [_check(hb, row_block)],
    dh_splits=lambda B, _S, _H, V, RB: dh_vocab_splits_v2(B, RB, V),
    launch_bwd=launch_recompute,
    plain_fwd=lambda *args: fused_splade_pool_v2_plain(*args),
    plain_bwd=lambda *args: fused_splade_bwd_v2_plain(*args))


def fused_splade_maxima_v2(h, w, bias, mask, row_block: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m [B, V], pos [B, S]) pre-activation maxima: the row-blocked forward
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    return family_maxima(ROW_BLOCKED, h, w, bias, mask, row_block)


def fused_splade_bwd_dh_v2(h, w, bias, mask, m, g_pre,
                           row_block: int = 0) -> torch.Tensor:
    """dh [B, S, H] f32 of the pool: the row-blocked dh kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    return family_bwd(ROW_BLOCKED, "dh", h, w, bias, mask, m, g_pre,
                      row_block)


def fused_splade_bwd_dw_v2(h, w, bias, mask, m, g_pre,
                           row_block: int = 0) -> torch.Tensor:
    """dW [V, H] f32 of the pool: the row-blocked dW kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    return family_bwd(ROW_BLOCKED, "dw", h, w, bias, mask, m, g_pre,
                      row_block)


def fused_splade_pool_v2(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, row_block: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [B, V] f32, token_weights [B, S] f32) from h [B, S, H], tied
    decoder w [V, H], bias [V] or None, attention mask [B, S], with
    ``row_block`` batch rows a block (0: the largest of 8, 4, 2, 1 dividing
    B). Differentiable in h, w and bias; token_weights carries no gradient.
    The launchers and the ``autograd.Function`` are the per-row family's
    (``ops/fused_splade.py``), over this family's kernels."""
    resolve_row_block(h.shape[0], row_block)  # refuse before any work
    return family_pool(ROW_BLOCKED, h, w, bias, mask, row_block)


#: kernel launches since the last reset, added where a kernel is launched
#: and nowhere else (never for the plain versions or an empty batch)
fused_splade_pool_v2.launches = 0
fused_splade_bwd_dh_v2.launches = 0
fused_splade_bwd_dw_v2.launches = 0
ROW_BLOCKED.counted.update(fwd=fused_splade_pool_v2,
                           dh=fused_splade_bwd_dh_v2,
                           dw=fused_splade_bwd_dw_v2)
