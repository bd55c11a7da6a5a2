"""Plain ModernBERT MLM model in float32: the benchmark's frozen copy of
the maths, written from HuggingFace's ``ModernBertForMaskedLM`` as
``skt/A.X-Encoder-base`` configures it.

22 pre-norm layers with fused QKV, RoPE (rotate-half) at theta 160,000 on
global layers (every third, from layer 0) and 10,000 on local layers,
which see keys within 64 positions either side; GeGLU MLPs with exact GELU;
LayerNorms without bias (eps 1e-5); layer 0 has no attention pre-norm; an
MLM head (dense, GELU, norm) and a decoder tied to the token embedding,
with bias. Attention sees only valid keys of the query's own segment (a
packed row holds several). Functional over a dict of tensors named as
HuggingFace names them (``core/weights.py``), so gradients are taken
against the same leaves the benchmark made.

``mm`` is every matrix product of the model. The float32 reference passes
``torch.matmul`` with TF32 off; the control passes a product of operands
rounded to a lower precision (``reference/precision.py``). Imports nothing
of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

MASK_NEG = -1e30
Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def linear(x: torch.Tensor, w: torch.Tensor, mm: Mm) -> torch.Tensor:
    return mm(x, w.t())


def norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w, None, eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, N, D]; pos [B, S] positions."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    ang = pos.to(torch.float32)[..., None] * inv                  # [B, S, D/2]
    ang = torch.cat([ang, ang], dim=-1)[:, :, None, :]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * ang.cos() + rot * ang.sin()


def attention_bias(mask: torch.Tensor, seg: torch.Tensor, half_window: int
                   ) -> torch.Tensor:
    """[B, 1, S, S] additive bias: a query sees valid keys of its own
    segment, within ``half_window`` positions when that is not 0."""
    S = mask.shape[1]
    ok = mask.bool()[:, None, :] & (seg[:, :, None] == seg[:, None, :])
    if half_window:
        idx = torch.arange(S, device=mask.device)
        ok = ok & ((idx[:, None] - idx[None, :]).abs() <= half_window)[None]
    return torch.where(ok, 0.0, MASK_NEG)[:, None].to(torch.float32)


def layer(p: Dict[str, torch.Tensor], cfg: dict, i: int, x, bias, pos,
          mm: Mm) -> torch.Tensor:
    pre = f"model.layers.{i}."
    B, S, H = x.shape
    N = cfg["num_attention_heads"]
    D = H // N
    glob = i % cfg["global_attn_every_n_layers"] == 0
    theta = cfg["global_rope_theta"] if glob else cfg["local_rope_theta"]
    eps = cfg["norm_eps"]
    h = x if i == 0 else norm(x, p[pre + "attn_norm.weight"], eps)
    qkv = linear(h, p[pre + "attn.Wqkv.weight"], mm).view(B, S, 3, N, D)
    q, k, v = (rope(qkv[:, :, 0], pos, theta), rope(qkv[:, :, 1], pos, theta),
               qkv[:, :, 2])
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(D)
    probs = torch.softmax(scores + bias, dim=-1)
    att = mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H)
    x = x + linear(att, p[pre + "attn.Wo.weight"], mm)
    h = norm(x, p[pre + "mlp_norm.weight"], eps)
    inp, gate = linear(h, p[pre + "mlp.Wi.weight"], mm).chunk(2, dim=-1)
    return x + linear(F.gelu(inp) * gate, p[pre + "mlp.Wo.weight"], mm)


def encode(p: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
           mask: torch.Tensor, pos: Optional[torch.Tensor] = None,
           seg: Optional[torch.Tensor] = None, mm: Mm = f32_mm
           ) -> torch.Tensor:
    """[B, S] ids -> [B, S, H] final-normed hidden states (float32)."""
    B, S = ids.shape
    if pos is None:
        pos = torch.arange(S, device=ids.device).expand(B, S)
    if seg is None:
        seg = torch.zeros_like(ids)
    eps = cfg["norm_eps"]
    x = norm(p["model.embeddings.tok_embeddings.weight"][ids].float(),
             p["model.embeddings.norm.weight"], eps)
    biases = {hw: attention_bias(mask, seg, hw)
              for hw in (0, cfg["local_attention"] // 2)}
    for i in range(cfg["num_hidden_layers"]):
        glob = i % cfg["global_attn_every_n_layers"] == 0
        x = layer(p, cfg, i, x, biases[0 if glob else
                                       cfg["local_attention"] // 2], pos, mm)
    return norm(x, p["model.final_norm.weight"], eps)


def head(p: Dict[str, torch.Tensor], cfg: dict, h: torch.Tensor,
         mm: Mm = f32_mm) -> torch.Tensor:
    """The MLM head before the vocabulary projection."""
    return norm(F.gelu(linear(h, p["head.dense.weight"], mm)),
                p["head.norm.weight"], cfg["norm_eps"])


def vocab_logits(p: Dict[str, torch.Tensor], t: torch.Tensor,
                 mm: Mm = f32_mm) -> torch.Tensor:
    return linear(t, p["model.embeddings.tok_embeddings.weight"], mm) \
        + p["decoder.bias"]
