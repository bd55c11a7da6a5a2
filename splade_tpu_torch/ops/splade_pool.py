"""SPLADE-max pooling over the vocabulary: the plain PyTorch versions.

Counterpart of ``splade_tpu/ops/splade_pool.py``. ``log1p(relu(x))`` is
monotonic with a fixed point at 0 for x <= 0, and masked positions
contribute exactly 0, so the pooling commutes with the activation:

    sparse_repr[b, v] = log1p(relu( max over valid s of logits[b, s, v] ))

``splade_pool_streamed`` uses that to project the vocabulary tile by tile
and never build the [B, S, V] logits. ``splade_pool_from_logits`` is the
reference-shaped path kept as the parity oracle. The hand-written kernel
of the same function is ``ops/fused_splade.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e30


def splade_pool_from_logits(
    logits: torch.Tensor, attention_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference-shaped pooling from full [B, S, V] logits.

    Returns (sparse_repr [B, V] f32, token_weights [B, S] f32)."""
    mask = attention_mask.to(torch.float32)
    scores = torch.log1p(torch.relu(logits.to(torch.float32)))
    scores = scores * mask[:, :, None]
    return scores.amax(dim=1), scores.amax(dim=-1)


def masked_scores(x: torch.Tensor, emb: torch.Tensor,
                  bias: Optional[torch.Tensor], valid: torch.Tensor, v0: int,
                  tile: int) -> torch.Tensor:
    """[B, S, tile] f32 scores of vocab columns v0..v0+tile, invalid
    positions -1e30: x [B, S, H] f32, valid [B, S, 1] bool. The one
    expression the streamed maxima and the plain backward both evaluate, so
    a recompute at the same tile equals the forward's scores bit for bit."""
    w = emb[v0:v0 + tile].to(torch.float32)
    logits = x @ w.T                                       # [B, S, tile]
    if bias is not None:
        logits = logits + bias[v0:v0 + tile].to(torch.float32)
    return torch.where(valid, logits, torch.full_like(logits, NEG))


def masked_max_streamed(
    transformed: torch.Tensor,
    emb: torch.Tensor,
    bias: Optional[torch.Tensor],
    attention_mask: torch.Tensor,
    tile: int = 6250,
    with_token_weights: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-activation maxima, one vocab tile at a time, in f32 (products in
    f32 under autocast too, as JAX's ``preferred_element_type``):
    (m [B, V] = max over valid s, pos [B, S] = max over v or None)."""
    B, S, H = transformed.shape
    V = emb.shape[0]
    dev = transformed.device
    with torch.autocast(dev.type, enabled=False):
        x = transformed.to(torch.float32)
        valid = attention_mask.to(torch.bool)[:, :, None]
        m_parts = []
        pos = (torch.full((B, S), NEG, dtype=torch.float32, device=dev)
               if with_token_weights else None)
        for v0 in range(0, V, tile):
            masked = masked_scores(x, emb, bias, valid, v0, tile)
            m_parts.append(masked.amax(dim=1))
            if pos is not None:  # monitoring only: no gradient, as JAX
                pos = torch.maximum(pos, masked.amax(dim=2).detach())
        m = (torch.cat(m_parts, dim=1) if m_parts
             else torch.empty((B, 0), dtype=torch.float32, device=dev))
    return m, pos


def splade_pool_streamed(
    transformed: torch.Tensor,
    emb: torch.Tensor,
    bias: Optional[torch.Tensor],
    attention_mask: torch.Tensor,
    tile: int = 6250,
    with_token_weights: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused vocab projection + masked seq-max without [B, S, V].

    transformed [B, S, H] head-transformed states, emb [V, H] tied decoder
    weights, bias [V] or None, attention_mask [B, S]. Any ``tile`` works
    (the last one may be short). Returns (sparse_repr [B, V] f32,
    token_weights [B, S] f32); with_token_weights=False skips the
    per-position max and returns zeros, as the JAX function does."""
    m, pos = masked_max_streamed(transformed, emb, bias, attention_mask,
                                 tile, with_token_weights)
    sparse_repr = torch.log1p(torch.relu(m))
    if pos is None:
        return sparse_repr, torch.zeros(
            attention_mask.shape, dtype=torch.float32,
            device=transformed.device)
    token_weights = (torch.log1p(torch.relu(pos))
                     * attention_mask.to(torch.float32))
    return sparse_repr, token_weights
