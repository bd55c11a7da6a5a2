"""SPLADE-max encoder: ModernBERT backbone + vocabulary max-pooling.

Counterpart of ``splade_tpu/models/splade.py``. ``forward`` returns
(sparse_repr [B, V] f32, token_weights [B, S] f32); ``encode`` is the
inference shortcut; ``forward_packed_qd`` is the training forward with the
packed query tower; ``top_k_tokens`` is the debug decode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                ModernBertForMaskedLM)
from splade_tpu_torch.ops.fused_splade import fused_splade_pool
from splade_tpu_torch.ops.splade_pool import (splade_pool_from_logits,
                                              splade_pool_streamed)
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

POOL_IMPLS = ("logits", "streamed", "kernel")


class SpladeEncoder(nn.Module):
    """SPLADE-max model over a ModernBERT MLM backbone.

    pool_impl:
        'kernel'   — the hand-written Hopper kernel (ops/fused_splade.py),
                     counterpart of 'pallas'; the serving default. On the
                     CPU its wrapper runs the plain version.
        'streamed' — plain PyTorch vocab-tile projection + max, never
                     materializes [B, S, V].
        'logits'   — reference-shaped full-logits path (parity oracle).
    """

    def __init__(self, config: ModernBertConfig, pool_impl: str = "kernel",
                 pool_tile: int = 6250, with_token_weights: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        if pool_impl not in POOL_IMPLS:
            raise ValueError(f"pool_impl {pool_impl!r} not in {POOL_IMPLS}")
        self.config = config
        self.pool_impl = pool_impl
        self.pool_tile = pool_tile
        self.with_token_weights = with_token_weights
        with torch.device(resolve_device(device)):
            self.mlm = ModernBertForMaskedLM(config)

    @property
    def device(self) -> torch.device:
        return self.mlm.decoder.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> "SpladeEncoder":
        """Seeded random weights (normal 0.02, unit norms, zero biases),
        drawn by a generator on the model's device."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=g)
        return self

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        hidden = self.mlm.encode(input_ids, attention_mask)
        return self._pool(self.mlm.head_transform(hidden), attention_mask)

    def _pool(self, transformed: torch.Tensor, attention_mask: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, S, H] head-transformed states -> (sparse [B, V], token_w [B, S])."""
        if self.pool_impl == "logits":
            return splade_pool_from_logits(
                self.mlm.project_vocab(transformed), attention_mask)
        emb, bias = self.mlm.decoder_weights()
        # Under autocast (training) the head's LayerNorm returns f32; JAX's
        # head returns the compute dtype, so cast to it here. The kernels
        # then take the embedding in that dtype too, cast once per call (as
        # JAX casts it); the streamed path keeps it in f32, as JAX does.
        dev = transformed.device.type
        if torch.is_autocast_enabled(dev):
            transformed = transformed.to(torch.get_autocast_dtype(dev))
        if self.pool_impl == "kernel":
            return fused_splade_pool(transformed, emb.to(transformed.dtype),
                                     bias, attention_mask)
        return splade_pool_streamed(
            transformed, emb, bias, attention_mask, tile=self.pool_tile,
            with_token_weights=self.with_token_weights)

    def forward_packed_qd(
        self,
        query_input_ids: torch.Tensor,
        query_attention_mask: torch.Tensor,
        doc_input_ids: torch.Tensor,
        doc_attention_mask: torch.Tensor,
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
               Tuple[torch.Tensor, torch.Tensor]]:
        """Queries + docs in ONE backbone forward, queries sequence-packed.

        S_doc // S_q queries share each doc-shaped row (RoPE positions
        restart per segment, attention is segment-masked), appended to the
        doc batch, so the micro-batch is one uniform [R, S_doc] stream; when
        B is not a multiple of the pack, the last row holds mask-0 segments.
        Docs and queries are then pooled separately from the same
        transformed stream. Same math as the unpacked path up to reduction
        order. Returns ((q_sparse [B,V], q_token_w), (d_sparse [D,V],
        d_token_w))."""
        B, Sq = query_input_ids.shape
        D, Sd = doc_input_ids.shape
        if Sd % Sq != 0:
            raise ValueError(f"doc len {Sd} must be a multiple of query len {Sq}")
        pack = Sd // Sq
        rows = -(-B // pack)  # ceil: last row may hold empty (mask-0) segments
        pad_n = rows * pack - B
        q_ids, q_mask = query_input_ids, query_attention_mask
        if pad_n:
            q_ids = torch.cat([q_ids, q_ids.new_zeros((pad_n, Sq))])
            q_mask = torch.cat([q_mask, q_mask.new_zeros((pad_n, Sq))])
        dev = doc_input_ids.device
        ids = torch.cat([doc_input_ids, q_ids.reshape(rows, Sd).to(
            doc_input_ids.dtype)])
        mask = torch.cat([doc_attention_mask, q_mask.reshape(rows, Sd).to(
            doc_attention_mask.dtype)])
        positions = torch.cat([
            torch.arange(Sd, device=dev).expand(D, Sd),
            torch.arange(Sq, device=dev).repeat(pack).expand(rows, Sd),
        ])
        segment_ids = torch.cat([
            torch.zeros((D, Sd), dtype=torch.long, device=dev),
            torch.arange(pack, device=dev).repeat_interleave(Sq).expand(
                rows, Sd),
        ])
        hidden = self.mlm.encode(ids, mask, positions=positions,
                                 segment_ids=segment_ids)
        transformed = self.mlm.head_transform(hidden)
        t_doc = transformed[:D]
        t_q = transformed[D:].reshape(rows * pack, Sq, -1)[:B]
        doc_out = self._pool(t_doc, doc_attention_mask)
        q_out = self._pool(t_q, query_attention_mask)
        return q_out, doc_out

    def encode(self, input_ids: torch.Tensor,
               attention_mask: torch.Tensor) -> torch.Tensor:
        """Inference shortcut -> sparse_repr [B, V]."""
        return self(input_ids, attention_mask)[0]


def top_k_tokens(sparse_repr, tokenizer, k: int = 50) -> Dict[str, float]:
    """Debug decode of the strongest vocabulary activations for one vector
    (reference: src/model/splade_modern.py:99-114)."""
    import numpy as np

    if isinstance(sparse_repr, torch.Tensor):
        sparse_repr = sparse_repr.detach().float().cpu().numpy()
    vec = np.asarray(sparse_repr).reshape(-1)
    k = min(k, vec.shape[0])
    top_ids = np.argpartition(-vec, k - 1)[:k]
    top_ids = top_ids[np.argsort(-vec[top_ids])]
    out: Dict[str, float] = {}
    for idx in top_ids:
        val = float(vec[idx])
        if val > 0:
            out[tokenizer.decode([int(idx)]).strip()] = val
    return out
