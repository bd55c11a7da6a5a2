"""ModernBERT encoder + MLM head in PyTorch.

Counterpart of ``splade_tpu/models/modernbert.py`` (and of HuggingFace's
``ModernBertForMaskedLM``, whose parameter names it uses, so an HF state
dict loads with ``load_state_dict``): 22 pre-norm layers, fused QKV, GeGLU
MLPs with exact GELU, bias-free LayerNorm (eps 1e-5), RoPE in the
rotate-half convention with global layers (every 3rd, theta 160000) and
local layers (theta 10000, a +/-64 sliding window), and a tied MLM decoder
with bias.

Attention is the JAX package's plain math: QKV product, RoPE, scores in f32
plus an additive mask (-1e30, not -inf), softmax, V product. The model
computes in the dtype of its parameters (bf16 on the card, f32 in the
parity tests). The head transform and the vocab projection are separate
methods, so the SPLADE pool can fuse the projection with the seq-max.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Large finite negative for additive masks: -inf would NaN fully masked rows
# (padded queries whose whole window is padding) and leak into valid rows.
MASK_NEG = -1e30


@dataclass(frozen=True)
class ModernBertConfig:
    vocab_size: int = 50000
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    global_attn_every_n_layers: int = 3
    local_attention: int = 128  # full window width; half-window each side
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    pad_token_id: int = 49999
    max_position_embeddings: int = 16384
    decoder_bias: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def is_global_layer(self, layer_id: int) -> bool:
        return layer_id % self.global_attn_every_n_layers == 0

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any], **over: Any) -> "ModernBertConfig":
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: d[k] for k in keys if k in d}
        kw.update(over)
        return cls(**kw)

    @classmethod
    def tiny(cls, **over: Any) -> "ModernBertConfig":
        """Small config for unit tests."""
        base = dict(
            vocab_size=512, hidden_size=64, intermediate_size=96,
            num_hidden_layers=4, num_attention_heads=4, local_attention=8,
            pad_token_id=511,
        )
        base.update(over)
        return cls(**base)


def rope_cos_sin(seq_len: int, head_dim: int, theta: float,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [S, D], HF rotate-half convention: concat(freqs, freqs)."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    emb = torch.cat([torch.outer(pos, inv_freq)] * 2, dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, S, N, D]; cos/sin [S, D] (shared) or [B, S, D] (per-row
    positions: the packed-sequence path)."""
    d2 = x.shape[-1] // 2
    rotated = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return x * c + rotated * s


def sliding_window_bias(seq_len: int, half_window: int,
                        device: Optional[torch.device] = None) -> torch.Tensor:
    """[S, S] additive bias: 0 where |i - j| <= half_window, else -1e30."""
    idx = torch.arange(seq_len, device=device)
    dist = (idx[:, None] - idx[None, :]).abs()
    return torch.where(dist <= half_window, 0.0, MASK_NEG).to(torch.float32)


def _norm(config: ModernBertConfig) -> nn.LayerNorm:
    return nn.LayerNorm(config.hidden_size, eps=config.norm_eps, bias=False)


class ModernBertAttention(nn.Module):
    def __init__(self, config: ModernBertConfig):
        super().__init__()
        H = config.hidden_size
        self.n_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        self.Wqkv = nn.Linear(H, 3 * H, bias=False)
        self.Wo = nn.Linear(H, H, bias=False)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        qkv = self.Wqkv(x).view(B, S, 3, self.n_heads, self.head_dim)
        q, k, v = qkv.unbind(2)                           # [B, S, N, D]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        # [B, N, S, S] scores in f32 for a stable softmax
        scores = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32)
        scores = scores / math.sqrt(self.head_dim) + attn_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(B, S, H)
        return self.Wo(out)


class ModernBertMLP(nn.Module):
    """GeGLU: Wi -> split(input, gate) -> gelu(input) * gate -> Wo."""

    def __init__(self, config: ModernBertConfig):
        super().__init__()
        self.Wi = nn.Linear(config.hidden_size, 2 * config.intermediate_size,
                            bias=False)
        self.Wo = nn.Linear(config.intermediate_size, config.hidden_size,
                            bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp, gate = self.Wi(x).chunk(2, dim=-1)
        return self.Wo(F.gelu(inp, approximate="none") * gate)


class ModernBertLayer(nn.Module):
    def __init__(self, config: ModernBertConfig, layer_id: int):
        super().__init__()
        # layer 0 has no attention pre-norm (the embedding norm covers it)
        self.attn_norm = nn.Identity() if layer_id == 0 else _norm(config)
        self.attn = ModernBertAttention(config)
        self.mlp_norm = _norm(config)
        self.mlp = ModernBertMLP(config)

    def forward(self, x, attn_bias, cos, sin):
        x = x + self.attn(self.attn_norm(x), attn_bias, cos, sin)
        return x + self.mlp(self.mlp_norm(x))


class _Embeddings(nn.Module):
    def __init__(self, config: ModernBertConfig):
        super().__init__()
        self.tok_embeddings = nn.Embedding(config.vocab_size,
                                           config.hidden_size)
        self.norm = _norm(config)


class _Backbone(nn.Module):
    def __init__(self, config: ModernBertConfig):
        super().__init__()
        self.embeddings = _Embeddings(config)
        self.layers = nn.ModuleList(
            ModernBertLayer(config, i) for i in range(config.num_hidden_layers))
        self.final_norm = _norm(config)


class _Head(nn.Module):
    def __init__(self, config: ModernBertConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               bias=False)
        self.norm = _norm(config)


class ModernBertForMaskedLM(nn.Module):
    """Backbone + MLM head with the decoder tied to the token embedding.

    Counterpart of ``splade_tpu.models.modernbert.ModernBertForMaskedLM``;
    the layers are a flat ``nn.ModuleList`` under HF names
    (``model.layers.{i}.attn.Wqkv.weight``, ...)."""

    def __init__(self, config: ModernBertConfig):
        super().__init__()
        self.config = config
        self.model = _Backbone(config)
        self.head = _Head(config)
        self.decoder = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=config.decoder_bias)
        self.decoder.weight = self.model.embeddings.tok_embeddings.weight

    def encode(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """[B, S] ids -> [B, S, H] final-normed hidden states.

        positions [B, S]: per-token RoPE position (None = arange(S));
        segment_ids [B, S]: tokens attend only within their own segment
        (None = one segment per row). Both serve sequence packing."""
        cfg = self.config
        S = input_ids.shape[1]
        dev = input_ids.device
        emb = self.model.embeddings
        x = emb.norm(emb.tok_embeddings(input_ids))
        key_ok = attention_mask.to(torch.bool)[:, None, :]        # [B, 1, S]
        if segment_ids is not None:
            key_ok = key_ok & (segment_ids[:, :, None]
                               == segment_ids[:, None, :])         # [B, S, S]
        pad_bias = torch.where(key_ok[:, None], 0.0, MASK_NEG).to(
            torch.float32)                                # [B, 1, 1|S, S]
        local_bias = pad_bias + sliding_window_bias(
            S, cfg.local_attention // 2, dev)[None, None]
        dtype = x.dtype
        g_cos, g_sin = rope_cos_sin(S, cfg.head_dim, cfg.global_rope_theta,
                                    dtype, dev)
        l_cos, l_sin = rope_cos_sin(S, cfg.head_dim, cfg.local_rope_theta,
                                    dtype, dev)
        if positions is not None:
            g_cos, g_sin = g_cos[positions], g_sin[positions]
            l_cos, l_sin = l_cos[positions], l_sin[positions]
        for i, layer in enumerate(self.model.layers):
            if cfg.is_global_layer(i):
                x = layer(x, pad_bias, g_cos, g_sin)
            else:
                x = layer(x, local_bias, l_cos, l_sin)
        return self.model.final_norm(x)

    def head_transform(self, hidden: torch.Tensor) -> torch.Tensor:
        """MLM prediction head (dense -> gelu -> norm), pre-projection."""
        return self.head.norm(F.gelu(self.head.dense(hidden),
                                     approximate="none"))

    def decoder_weights(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(embedding [V, H], bias [V] or None): the tied vocab projection."""
        return self.decoder.weight, self.decoder.bias

    def project_vocab(self, transformed: torch.Tensor) -> torch.Tensor:
        """Tied decoder: [..., H] -> [..., V] logits."""
        bias = self.decoder.bias
        return F.linear(transformed, self.decoder.weight,
                        None if bias is None else bias.to(transformed.dtype))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """Full MLM forward: [B, S] -> [B, S, V] logits."""
        return self.project_vocab(self.head_transform(
            self.encode(input_ids, attention_mask)))
