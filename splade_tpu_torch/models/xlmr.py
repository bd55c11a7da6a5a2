"""XLM-RoBERTa encoder in PyTorch: the BGE-M3 teacher backbone.

Counterpart of ``splade_tpu/models/xlmr.py``: a post-LN BERT layout with
learned positions after the RoBERTa padding offset, whose CLS output is
BGE-M3's dense embedding. The reference computes it with plain einsums,
dense layers, LayerNorm and exact GELU, outside any Pallas kernel, so the
port is plain ``torch.matmul`` and ``torch.nn.functional``.

It keeps the reference's order of casts. Embedding tables, dense kernels
and their biases take the compute dtype (``config.dtype``); the attention
scores leave the q·kᵀ product in that dtype and go to f32, are scaled by
1/sqrt(d), get the additive -1e30 mask bias and a softmax in f32, and the
probabilities return to the compute dtype. LayerNorm keeps f32 parameters,
computes on f32 values with eps 1e-5 and casts back.

Parameter names are HF ``XLMRobertaModel``'s, so an HF state dict loads as
it is (``port_xlmr_state_dict`` drops a ``roberta.`` prefix, the pooler and
the position-id buffers). ``xlmr_state_from_jax`` carries a ``splade_tpu``
parameter tree across.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class XlmRobertaConfig:
    vocab_size: int = 250002
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    max_position_embeddings: int = 8194
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any], **over: Any) -> "XlmRobertaConfig":
        keys = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
        kw = {k: d[k] for k in keys if k in d}
        kw.update(over)
        return cls(**kw)

    @classmethod
    def tiny(cls, **over: Any) -> "XlmRobertaConfig":
        base = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=66, pad_token_id=1)
        base.update(over)
        return cls(**base)


def roberta_position_ids(input_ids: torch.Tensor,
                         pad_token_id: int) -> torch.Tensor:
    """RoBERTa convention: positions count non-pad tokens, offset by pad+1."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """f32 statistics and parameters, the result in x's dtype."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


class XlmrLayer(nn.Module):
    """One post-LN layer, under HF's parameter names."""

    def __init__(self, cfg: XlmRobertaConfig):
        super().__init__()
        H, dt = cfg.hidden_size, cfg.dtype
        lin = lambda i, o: nn.Linear(i, o, dtype=dt)
        norm = lambda: nn.LayerNorm(H, eps=cfg.layer_norm_eps,
                                    dtype=torch.float32)
        self.cfg = cfg
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({"query": lin(H, H), "key": lin(H, H),
                                   "value": lin(H, H)}),
            "output": nn.ModuleDict({"dense": lin(H, H),
                                     "LayerNorm": norm()})})
        self.intermediate = nn.ModuleDict(
            {"dense": lin(H, cfg.intermediate_size)})
        self.output = nn.ModuleDict(
            {"dense": lin(cfg.intermediate_size, H), "LayerNorm": norm()})

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        B, S, H = x.shape
        n, d = self.cfg.num_attention_heads, self.cfg.head_dim
        sa = self.attention["self"]
        heads = lambda t: t.view(B, S, n, d).transpose(1, 2)  # [B, n, S, d]
        q, k, v = (heads(sa[name](x)) for name in ("query", "key", "value"))
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        scores = scores / math.sqrt(d) + attn_bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, H)
        out = self.attention["output"]
        x = _layer_norm(out["LayerNorm"], x + out["dense"](ctx))
        inter = F.gelu(self.intermediate["dense"](x))
        return _layer_norm(self.output["LayerNorm"],
                           x + self.output["dense"](inter))


class XlmRobertaEncoder(nn.Module):
    """Embeddings + post-LN transformer stack -> last hidden states."""

    def __init__(self, config: XlmRobertaConfig):
        super().__init__()
        cfg = self.config = config
        emb = lambda n: nn.Embedding(n, cfg.hidden_size, dtype=cfg.dtype)
        self.embeddings = nn.ModuleDict({
            "word_embeddings": emb(cfg.vocab_size),
            "position_embeddings": emb(cfg.max_position_embeddings),
            "token_type_embeddings": emb(cfg.type_vocab_size),
            "LayerNorm": nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                      dtype=torch.float32)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            XlmrLayer(cfg) for _ in range(cfg.num_hidden_layers))})

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        e = self.embeddings
        pos_ids = roberta_position_ids(input_ids, self.config.pad_token_id)
        x = (e["word_embeddings"](input_ids)
             + e["position_embeddings"](pos_ids)
             + e["token_type_embeddings"](torch.zeros_like(input_ids)))
        x = _layer_norm(e["LayerNorm"], x)
        bias = torch.where(attention_mask[:, None, None, :].bool(), 0.0,
                           -1e30)
        for layer in self.encoder["layer"]:
            x = layer(x, bias)
        return x

    def encode_cls(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor) -> torch.Tensor:
        """BGE-M3 dense embedding: L2-normalized CLS hidden state, f32."""
        cls = self(input_ids, attention_mask)[:, 0, :].float()
        return cls / torch.clamp(torch.linalg.norm(cls, dim=-1, keepdim=True),
                                 min=1e-9)


#: HF buffers that are not parameters of the port's module
_HF_BUFFERS = ("embeddings.position_ids", "embeddings.token_type_ids")


def port_xlmr_state_dict(state: Mapping[str, Any],
                         config: XlmRobertaConfig) -> Dict[str, torch.Tensor]:
    """HF XLMRobertaModel state dict (tensors or numpy arrays, with or
    without the ``roberta.`` prefix) -> the port's state dict, f32: the
    pooler and the position-id buffers dropped, ``config``'s layers only."""
    pre = "roberta." if any(k.startswith("roberta.") for k in state) else ""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if not key.startswith(pre):
            continue
        name = key[len(pre):]
        if name.startswith("pooler.") or name in _HF_BUFFERS:
            continue
        if name.startswith("encoder.layer.") and int(
                name.split(".")[2]) >= config.num_hidden_layers:
            continue
        t = (value.detach().cpu() if isinstance(value, torch.Tensor)
             else torch.from_numpy(np.asarray(value)))
        out[name] = t.to(torch.float32).contiguous()
    return out


def xlmr_state_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``splade_tpu`` XlmRobertaEncoder params (nested numpy dicts, as
    ``port_xlmr_state_dict`` there makes them) -> the port's state dict.
    Flax kernels are [in, out] and become torch's [out, in]."""
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

    def lin(p):
        return {"weight": t(p["kernel"]).T.contiguous(), "bias": t(p["bias"])}

    def ln(p):
        return {"weight": t(p["scale"]), "bias": t(p["bias"])}

    def into(prefix, tensors):
        out.update({f"{prefix}.{k}": v for k, v in tensors.items()})

    out: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[f"embeddings.{name}.weight"] = t(params[name]["embedding"])
    into("embeddings.LayerNorm", ln(params["emb_norm"]))
    i = 0
    while f"layer_{i}" in params:
        p, pre = params[f"layer_{i}"], f"encoder.layer.{i}"
        for role in ("query", "key", "value"):
            into(f"{pre}.attention.self.{role}", lin(p[role]))
        into(f"{pre}.attention.output.dense", lin(p["attn_out"]))
        into(f"{pre}.attention.output.LayerNorm", ln(p["attn_norm"]))
        into(f"{pre}.intermediate.dense", lin(p["intermediate"]))
        into(f"{pre}.output.dense", lin(p["output"]))
        into(f"{pre}.output.LayerNorm", ln(p["out_norm"]))
        i += 1
    return out
