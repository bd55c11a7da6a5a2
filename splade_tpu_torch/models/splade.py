"""SPLADE-max encoder: ModernBERT backbone + vocabulary max-pooling.

Counterpart of ``splade_tpu/models/splade.py``. ``forward`` returns
(sparse_repr [B, V] f32, token_weights [B, S] f32); ``encode`` is the
inference shortcut. ``forward_packed_qd`` is training-only and comes with
the training slice (ROADMAP.md §1).
"""

from __future__ import annotations

from typing import Tuple

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
        if self.pool_impl == "kernel":
            return fused_splade_pool(transformed, emb.to(transformed.dtype),
                                     bias, attention_mask)
        return splade_pool_streamed(
            transformed, emb, bias, attention_mask, tile=self.pool_tile,
            with_token_weights=self.with_token_weights)

    def encode(self, input_ids: torch.Tensor,
               attention_mask: torch.Tensor) -> torch.Tensor:
        """Inference shortcut -> sparse_repr [B, V]."""
        return self(input_ids, attention_mask)[0]
