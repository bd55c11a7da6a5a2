"""Plain float32 DeepSeek-V3 as a SPLADE-max encoder, with the V33 loss.

The layer equations of HuggingFace's ``DeepseekV3ForCausalLM`` written
out in plain PyTorch, independent of the port (it imports torch alone):
RMSNorm; multi-head latent attention with q from ``q_proj``, the latent
``kv_a_proj_with_mqa`` -> ``kv_a_layernorm`` -> ``kv_b_proj``, one shared
k_pe head, RoPE turning each pair (2i, 2i+1) of q_pe and k_pe in place by
p·theta^(-2i/d) (HF gathers the pairs into halves first, the same dot
products), scores / sqrt(qk_head_dim) under causal ∧ same segment ∧ key
valid; a dense SwiGLU in the first ``first_k_dense_replace`` layers, then
the mixture of experts: sigmoid router scores, the top k of score +
correction bias chosen, the chosen unbiased scores normalised (+1e-20)
and scaled, each held expert applied to the tokens that chose it, plus
the shared experts. ``expert_shares`` / ``expert_share`` in the config say
which experts are held (all when absent); the others add nothing.

Functional over a dict of tensors under HF's names (the port's too), so
gradients are taken against the same leaves. SPLADE-max: log1p(relu(max
over valid positions of final_norm(h) · lm_head^T)). The V33 loss: InfoNCE
over the in-batch positives and each query's hard negatives, temperature
1, plus FLOPS regularisers weighted by a quadratic warm-up. Call
``tf32_off()`` before running it on a card.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

MASK_NEG = -1e30


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope_pairs(x, pos, theta):
    """x [B, S, N, d]: each pair (2i, 2i+1) turned by pos · theta^(-2i/d)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = pos.to(torch.float32)[..., None] * inv          # [B, S, d/2]
    c, s = ang.cos()[:, :, None], ang.sin()[:, :, None]
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1).flatten(-2)


def swiglu(x, gate, up, down):
    return F.silu(x @ gate.t()) * (x @ up.t()) @ down.t()


def attention(p, pre, cfg, x, allowed, pos):
    B, S, _ = x.shape
    N = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = (x @ p[pre + "q_proj.weight"].t()).view(B, S, N, dn + dr)
    a = x @ p[pre + "kv_a_proj_with_mqa.weight"].t()
    c, k_pe = a[..., :r], a[..., r:]
    kv = (rms_norm(c, p[pre + "kv_a_layernorm.weight"], cfg["rms_norm_eps"])
          @ p[pre + "kv_b_proj.weight"].t()).view(B, S, N, dn + dv)
    q_pe = rope_pairs(q[..., dn:], pos, cfg["rope_theta"])
    k_pe = rope_pairs(k_pe[:, :, None, :], pos, cfg["rope_theta"])
    scores = (torch.einsum("bqnd,bknd->bnqk", q[..., :dn], kv[..., :dn])
              + torch.einsum("bqnd,bkd->bnqk", q_pe, k_pe[:, :, 0]))
    scores = scores / (dn + dr) ** 0.5
    scores = scores.masked_fill(~allowed[:, None], MASK_NEG)
    out = torch.einsum("bnqk,bknd->bqnd", torch.softmax(scores, -1),
                       kv[..., dn:])
    return out.reshape(B, S, N * dv) @ p[pre + "o_proj.weight"].t()


def held(cfg):
    E = cfg["n_routed_experts"]
    shares = cfg.get("expert_shares", 1)
    n = E // shares
    first = cfg.get("expert_share", 0) * n
    return first, n


def moe_routed(p, pre, cfg, x):
    """[T, H] -> the held experts' weighted part [T, H] and the chosen
    experts [T, k]."""
    scores = torch.sigmoid(x @ p[pre + "gate.weight"].t())
    idx = torch.topk(scores + p[pre + "gate.e_score_correction_bias"],
                     cfg["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    first, n = held(cfg)
    gate_up, down = p[pre + "experts.gate_up_proj"], p[pre + "experts.down_proj"]
    inner = gate_up.shape[1] // 2
    out = torch.zeros_like(x)
    for e in range(n):
        tok, slot = (idx == first + e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], gate_up[e, :inner], gate_up[e, inner:],
                       down[e])
            out = out.index_add(0, tok, y * w[tok, slot, None])
    return out, idx


def moe(p, pre, cfg, x):
    B, S, H = x.shape
    routed, _ = moe_routed(p, pre + "mlp.", cfg, x.reshape(-1, H))
    sp = pre + "mlp.shared_experts."
    return routed.view(B, S, H) + swiglu(
        x, p[sp + "gate_proj.weight"], p[sp + "up_proj.weight"],
        p[sp + "down_proj.weight"])


def encode(p: Dict[str, torch.Tensor], cfg: dict, ids, mask,
           pos: Optional[torch.Tensor] = None,
           seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] ids -> [B, S, H] final-normed hidden states."""
    B, S = ids.shape
    if pos is None:
        pos = torch.arange(S, device=ids.device).expand(B, S)
    idx = torch.arange(S, device=ids.device)
    allowed = mask.bool()[:, None, :] & (idx[:, None] >= idx[None, :])[None]
    if seg is not None:
        allowed = allowed & (seg[:, :, None] == seg[:, None, :])
    eps = cfg["rms_norm_eps"]
    x = p["model.embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        x = x + attention(p, pre + "self_attn.", cfg, rms_norm(
            x, p[pre + "input_layernorm.weight"], eps), allowed, pos)
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, p[pre + "mlp.gate_proj.weight"],
                           p[pre + "mlp.up_proj.weight"],
                           p[pre + "mlp.down_proj.weight"])
        else:
            x = x + moe(p, pre, cfg, h)
    return rms_norm(x, p["model.norm.weight"], eps)


def splade(p, cfg, ids, mask) -> torch.Tensor:
    """[B, S] -> [B, V] SPLADE-max vectors."""
    logits = encode(p, cfg, ids, mask) @ p["lm_head.weight"].t()
    logits = logits.masked_fill(~mask.bool()[:, :, None], MASK_NEG)
    return torch.log1p(torch.relu(logits.amax(dim=1)))


def lambda_at(step, target, warmup, r0):
    t = min(step / max(warmup, 1), 1.0)
    return target * (r0 + (1.0 - r0) * t * t)


def flops(rep):
    mean = rep.mean(dim=0)
    return (mean * mean).sum()


def v33_loss(q, d_pos, d_neg, step: int, loss_cfg: dict) -> torch.Tensor:
    """q, d_pos [B, V], d_neg [B, n, V] -> the loss at optimizer step
    ``step`` (one block of in-batch negatives)."""
    B = q.shape[0]
    scores = torch.cat([q @ d_pos.t(),
                        torch.einsum("bv,bnv->bn", q, d_neg)], dim=1)
    scores = scores / loss_cfg["temperature"]
    idx = torch.arange(B, device=q.device)
    infonce = (torch.logsumexp(scores, dim=1) - scores[idx, idx]).mean()
    sched = (loss_cfg["flops_warmup_steps"], loss_cfg["lambda_initial_ratio"])
    lam_d = loss_cfg["lambda_d"]
    lam_n = loss_cfg.get("lambda_neg", 0.0) or lam_d
    return (infonce + lambda_at(step, loss_cfg["lambda_q"], *sched) * flops(q)
            + lambda_at(step, lam_d, *sched) * flops(d_pos)
            + lambda_at(step, lam_n, *sched) * flops(d_neg.reshape(
                -1, d_neg.shape[-1])))
