"""Row-blocked variant of the fused SPLADE pool, with its gradient.

Counterpart of ``splade_tpu/ops/fused_splade_v2.py::fused_splade_pool_v2``
(a ``jax.custom_vjp``; here a ``torch.autograd.Function``). The function is
``ops/fused_splade.py``'s:

    m[b, v]      = max over valid s of ( h[b,s,:] . W[v,:] + bias[v] )
    pooled[b, v] = log1p(relu(m[b, v]))
    token_w[b,s] = log1p(relu(max_v of the same)) * mask[b, s]

with ``row_block`` batch rows handled together. The forward
(``splade_fused_pool_v2_fwd`` in ``csrc/fused_splade_fwd.cu``, replacing
``_fwd_kernel`` at ``fused_splade_v2.py:46``) is the per-row family's
kernel launched with exactly ``row_block`` batch rows a block: a block owns
one 128-column vocab tile and walks the row block's live 16-row groups
against it on the register-resident walk of ``csrc/fused_splade_walk.cuh``,
streaming 32-wide k-slices of h and W, so the hidden width does not bound
it; the row block's column keys and group list must fit one block's shared
memory (``fwd_shared_bytes``). The backward
(``csrc/fused_splade_v2_bwd.cu``, replacing ``_bwd_dh_kernel`` at ``:65``
and ``_bwd_dw_kernel`` at ``:87``) is "match once, gather twice": a match
pass in which a block owns one vocab tile and the live 16-row groups of
``row_block`` batch rows recomputes every score once into the argmax
bitmask ``[B, ceil(S/32), V]``; then the dh gather (its vocabulary split
into ordered ranges where word rows are few, the ranges' partial sums added
in order) and the dW gather of ``csrc/fused_splade_bwd.cu`` read it. The
per-row family (``ops/fused_splade.py``) runs this same match pass and the
same gathers, at its own row block; only the forwards differ. Every score
goes through ``csrc/fused_splade_tile.cuh``'s arithmetic, so this family's
``m`` equals the per-row forward's bit for bit, the bitmask is the same at
every row block, and either backward may recompute either forward.

``row_block=0`` picks the largest of 8, 4, 2, 1 that divides B; a
``row_block`` that does not divide B raises ``ValueError``. (The JAX
function's "8 or the whole batch" rule is a tiling constraint of the TPU's
compiler and does not carry over.) The gradient rules are
``fused_splade_pool``'s: token weights carry no gradient, ``g_pre`` and
``dbias`` are computed outside the kernels, ties get duplicate gradient, dh
and dW come back in the dtypes of h and w.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``fused_splade_pool_v2_plain``,
``fused_splade_bwd_v2_plain`` and ``fused_splade_bwd_match_v2_plain``.
There is no fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from splade_tpu_torch.ops.fused_splade import (PLAIN_TILE, KernelFamily,
                                               _check, family_bwd,
                                               family_match, family_maxima,
                                               family_pool,
                                               fused_splade_bwd_match_plain,
                                               resolve_row_block)
from splade_tpu_torch.ops.splade_pool import NEG


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
    """The backward's function in plain PyTorch (the family's CPU path):
    per row block, recompute the scores as ``fused_splade_pool_v2_plain``
    computed them, ``G = 1[masked == m] · g_pre`` with m and g_pre looked
    up by each flattened row's own b, ``dh = G @ W_tile`` summed over vocab
    tiles, ``dw = Gᵀ @ h`` summed over row blocks.
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


def fused_splade_bwd_match_v2_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, m: torch.Tensor, g_pre: torch.Tensor,
    row_block: int = 0,
) -> torch.Tensor:
    """The match pass in plain PyTorch, row block by row block as the
    kernel walks it: ``fused_splade_bwd_match_plain`` on each block of
    ``row_block`` batch rows. Returns int32 [B, ceil(S/32), V]."""
    B = h.shape[0]
    RB = resolve_row_block(B, row_block)
    if B == 0:
        return fused_splade_bwd_match_plain(h, w, bias, mask, m, g_pre)
    return torch.cat([fused_splade_bwd_match_plain(
        h[b0:b0 + RB], w, bias, mask[b0:b0 + RB], m[b0:b0 + RB],
        g_pre[b0:b0 + RB]) for b0 in range(0, B, RB)])


# the plain versions are looked up when called, not when the family is made
ROW_BLOCKED = KernelFamily(
    fwd_entry="splade_fused_pool_v2_fwd",
    block_args=lambda hb, row_block, backward: [
        _check(hb, row_block, backward)],
    plain_fwd=lambda *args: fused_splade_pool_v2_plain(*args),
    plain_match=lambda *args: fused_splade_bwd_match_v2_plain(*args),
    plain_bwd=lambda *args: fused_splade_bwd_v2_plain(*args))


def fused_splade_maxima_v2(h, w, bias, mask, row_block: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m [B, V], pos [B, S]) pre-activation maxima: the row-blocked forward
    kernel on a CUDA tensor, its plain version on a CPU tensor."""
    return family_maxima(ROW_BLOCKED, h, w, bias, mask, row_block)


def fused_splade_bwd_match_v2(h, w, bias, mask, m, g_pre,
                              row_block: int = 0) -> torch.Tensor:
    """The argmax bitmask, int32 [B, ceil(S/32), V]: the row-blocked match
    pass on a CUDA tensor, ``fused_splade_bwd_match_v2_plain`` on a CPU
    tensor."""
    return family_match(ROW_BLOCKED, h, w, bias, mask, m, g_pre, row_block)


def fused_splade_bwd_dh_v2(h, w, bias, mask, m, g_pre,
                           row_block: int = 0) -> torch.Tensor:
    """dh [B, S, H] f32 of the pool: the row-blocked match pass and the dh
    gather on a CUDA tensor, the plain version on a CPU tensor."""
    return family_bwd(ROW_BLOCKED, "dh", h, w, bias, mask, m, g_pre,
                      row_block)


def fused_splade_bwd_dw_v2(h, w, bias, mask, m, g_pre,
                           row_block: int = 0) -> torch.Tensor:
    """dW [V, H] f32 of the pool: the row-blocked match pass and the dW
    gather on a CUDA tensor, the plain version on a CPU tensor."""
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
#: the forward, the match pass, the dh gather and the dW gather
fused_splade_pool_v2.launches = 0
fused_splade_bwd_match_v2.launches = 0
fused_splade_bwd_dh_v2.launches = 0
fused_splade_bwd_dw_v2.launches = 0
ROW_BLOCKED.counted.update(fwd=fused_splade_pool_v2,
                           match=fused_splade_bwd_match_v2,
                           dh=fused_splade_bwd_dh_v2,
                           dw=fused_splade_bwd_dw_v2)
