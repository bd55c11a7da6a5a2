"""Plain DeepSeek-V3 SPLADE-max encoding and V33 gradients in float32, in
row blocks: the benchmark's frozen copy of the maths, written from
HuggingFace's ``DeepseekV3ForCausalLM`` as ``kakaocorp/kanana-2-30b-a3b``
configures it (``configs/kanana2-30b-a3b-splade.json``).

A layer: x + o_proj(MLA(RMSNorm(x))), then + FFN(RMSNorm(.)). MLA without
a q low-rank projection: q heads of 128 + 64, the latent c (512) through
its RMSNorm and ``kv_b_proj`` to each head's k_nope and v (128 each), one
shared k_pe head; RoPE turns each pair (2i, 2i+1) of q_pe and k_pe in
place by p·theta^(-2i/64) (HF gathers the pairs into halves first: the
same dot products); scores / sqrt(192) under causal ∧ same segment ∧ key
valid. Layer 0's FFN is a dense SwiGLU; the others: sigmoid router scores
over all ``expert_parallel.router_experts`` experts (float32 products, as
the configuration computes them), the top k of score + correction bias,
the chosen unbiased scores normalised (+1e-20) and scaled by 2.448, each
held expert (``n_routed_experts`` of them, share ``expert_parallel.share``)
applied to the tokens that chose it, plus the shared experts. The pool:
log1p(relu(max over valid positions of final_norm(h) · lm_head^T)).
Imports nothing of the program.

``mm`` is every other matrix product (the control passes fp8 operands,
``reference/precision.py``). ``fault`` puts one error in, for the controls:
"biased_weights" (weights from the biased scores), "no_shared" (the shared
experts left out), "flat_rope" (the pairs (i, i + 32) turned, not the
interleaved ones). ``routes``, when given, collects each MoE layer's
chosen experts and their weights (two [rows, S, k] on the host, in call
order).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from perfbench.reference.splade import v33_loss
from perfbench.reference.train import Reference

MASK_NEG = -1e30
#: rows a block of the graph-free pass, and of the pass with a graph (whose
#: [rows, S, V] logits and their gradients stay within the card's memory)
ROWS, GRAPH_ROWS = 32, 16
FAULTS = ("biased_weights", "no_shared", "flat_rope")


def f32_mm(a, b):
    return torch.matmul(a, b)


def linear(x, w, mm):
    """x [..., in] · w^T as one 2-D product (the control's fp8 backward
    then forms w's gradient as one product, not one a leading index)."""
    return mm(x.reshape(-1, x.shape[-1]), w.t()).view(*x.shape[:-1], -1)


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def swiglu(x, gate, up, down, mm):
    return linear(F.silu(linear(x, gate, mm)) * linear(x, up, mm), down, mm)


def rope(x, pos, theta: float, interleaved: bool = True):
    """x [B, S, N, d]: pairs (2i, 2i+1) turned by pos·theta^(-2i/d);
    ``interleaved`` False turns the pairs (i, i + d/2) instead."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = pos.to(torch.float32)[..., None] * inv
    c, s = ang.cos()[:, :, None], ang.sin()[:, :, None]
    if interleaved:
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], -1).flatten(-2)
    x0, x1 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], -1)


def attention(p, pre, cfg, x, allowed, pos, mm, fault):
    B, S, _ = x.shape
    N = cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = linear(x, p[pre + "q_proj.weight"], mm).view(B, S, N, dn + dr)
    a = linear(x, p[pre + "kv_a_proj_with_mqa.weight"], mm)
    kv = linear(rms_norm(a[..., :r], p[pre + "kv_a_layernorm.weight"],
                         cfg["rms_norm_eps"]),
                p[pre + "kv_b_proj.weight"], mm).view(B, S, N, dn + dv)
    inter = fault != "flat_rope"
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, cfg["rope_theta"],
                                     inter)], -1)
    k_pe = rope(a[..., r:][:, :, None], pos, cfg["rope_theta"], inter)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, N, dr)], -1)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(dn + dr)
    scores = scores.masked_fill(~allowed[:, None], MASK_NEG)
    out = mm(torch.softmax(scores, -1), kv[..., dn:].transpose(1, 2))
    return linear(out.transpose(1, 2).reshape(B, S, N * dv),
                  p[pre + "o_proj.weight"], mm)


def moe(p, pre, cfg, x, mm, fault, routes: Optional[list]):
    B, S, H = x.shape
    flat = x.reshape(-1, H)
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(flat @ p[pre + "gate.weight"].t())
    biased = scores + p[pre + "gate.e_score_correction_bias"]
    idx = torch.topk(biased, k, dim=-1).indices
    w = (biased if fault == "biased_weights" else scores).gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    if routes is not None:
        routes.append((idx.view(B, S, k).cpu(), w.view(B, S, k).cpu()))
    n = cfg["n_routed_experts"]
    first = cfg.get("expert_parallel", {}).get("share", 0) * n
    gate_up, down = p[pre + "experts.gate_up_proj"], p[pre + "experts.down_proj"]
    inner = gate_up.shape[1] // 2
    out = torch.zeros_like(flat)
    for e in range(n):
        tok, slot = (idx == first + e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(flat[tok], gate_up[e, :inner], gate_up[e, inner:],
                       down[e], mm)
            out = out.index_add(0, tok, y * w[tok, slot, None])
    out = out.view(B, S, H)
    if fault == "no_shared":
        return out
    sp = pre + "shared_experts."
    return out + swiglu(x, p[sp + "gate_proj.weight"], p[sp + "up_proj.weight"],
                        p[sp + "down_proj.weight"], mm)


def encode(p: Dict[str, torch.Tensor], cfg: dict, ids, mask, mm=f32_mm,
           fault: Optional[str] = None,
           routes: Optional[Dict[int, list]] = None) -> torch.Tensor:
    """[B, S] ids -> [B, S, H] final-normed hidden states (one segment a
    row: the reference never packs)."""
    B, S = ids.shape
    pos = torch.arange(S, device=ids.device).expand(B, S)
    idx = torch.arange(S, device=ids.device)
    allowed = mask.bool()[:, None, :] & (idx[:, None] >= idx[None, :])[None]
    eps = cfg["rms_norm_eps"]
    x = p["model.embed_tokens.weight"][ids].float()
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        x = x + attention(p, pre + "self_attn.", cfg, rms_norm(
            x, p[pre + "input_layernorm.weight"], eps), allowed, pos, mm,
            fault)
        h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(h, p[pre + "mlp.gate_proj.weight"],
                           p[pre + "mlp.up_proj.weight"],
                           p[pre + "mlp.down_proj.weight"], mm)
        else:
            x = x + moe(p, pre + "mlp.", cfg, h, mm, fault,
                        None if routes is None else routes.setdefault(i, []))
    return rms_norm(x, p["model.norm.weight"], eps)


def pool(p, cfg, ids, mask, mm=f32_mm, fault=None, routes=None):
    """[B, S] -> [B, V] SPLADE-max vectors of one block of rows."""
    logits = linear(encode(p, cfg, ids, mask, mm, fault, routes),
                    p["lm_head.weight"], mm)
    logits = logits.masked_fill(~mask.bool()[:, :, None], MASK_NEG)
    return torch.log1p(torch.relu(logits.amax(dim=1)))


def encode_rows(p, cfg, ids, mask, mm=f32_mm, fault=None, routes=None,
                rows: int = ROWS):
    return torch.cat([pool(p, cfg, ids[i:i + rows], mask[i:i + rows], mm,
                           fault, routes)
                      for i in range(0, ids.shape[0], rows)])


def v33_micro_grads(p, cfg, micro: dict, step: int, loss_cfg: dict,
                    mm=f32_mm, keep: Sequence[int] = (), fault=None,
                    routes: Optional[Dict[str, dict]] = None) -> float:
    """Loss of one micro-batch; its gradient is added to each leaf's
    ``.grad`` (as ``reference/splade.py``'s: vectors first without a
    graph, then each block again with one). ``routes``: name -> the
    chosen experts and their weights of the graph-free pass, by layer."""
    names = ("query", "positive", "negative")
    sel = (torch.as_tensor(list(keep), device=micro["query_ids"].device)
           if len(keep) else None)
    parts = {}
    for n in names:
        ids, mask = micro[n + "_ids"], micro[n + "_mask"]
        if sel is not None:
            ids, mask = ids[sel], mask[sel]
        parts[n] = (ids, mask)
    with torch.no_grad():
        reps = {n: encode_rows(p, cfg, *parts[n], mm, fault,
                               None if routes is None
                               else routes.setdefault(n, {}))
                for n in names}
    leaves = {n: r.clone().requires_grad_(True) for n, r in reps.items()}
    loss = v33_loss(leaves["query"], leaves["positive"], leaves["negative"],
                    step, loss_cfg)
    loss.backward()
    for n in names:
        ids, mask = parts[n]
        g = leaves[n].grad
        for i in range(0, ids.shape[0], GRAPH_ROWS):
            sl = slice(i, i + GRAPH_ROWS)
            pool(p, cfg, ids[sl], mask[sl], mm, fault).backward(g[sl])
    return float(loss.detach())


class UntiedReference(Reference):
    """``Reference`` (AdamW, clipping, the schedule) over untied weights:
    ``frozen`` tensors (the correction biases) take no gradient and no
    update. The initial values stay on the host (``initial``)."""

    def __init__(self, weights: Dict[str, torch.Tensor], lr, weight_decay,
                 clip, frozen=lambda name: False):
        self.p = {n: w.detach().float().clone().requires_grad_(not frozen(n))
                  for n, w in weights.items()}
        self.leaves: List[str] = [n for n in self.p if not frozen(n)]
        self.initial = {n: self.p[n].detach().to("cpu", copy=True)
                        for n in self.leaves}
        self.m = {n: torch.zeros_like(self.p[n]) for n in self.leaves}
        self.v = {n: torch.zeros_like(self.p[n]) for n in self.leaves}
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.step = 0

    def change_norms(self) -> Dict[str, float]:
        return {n: float((self.p[n].detach()
                          - self.initial[n].to(self.p[n].device))
                         .double().norm()) for n in self.leaves}
