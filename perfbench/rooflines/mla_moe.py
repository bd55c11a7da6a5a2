"""Model FLOPs of a DeepSeek-V3 decoder under the SPLADE pool, and the
least time of its held experts' grouped products (``models/deepseek_v3.py``):
2 operations a multiply-add, counted at the valid tokens only.

Forward, a valid token: each layer's MLA projections, 2 H·N·(dn + dr)
(``q_proj``) + 2 H·(r + dr) (``kv_a_proj_with_mqa``) + 2 r·N·(dn + dv)
(``kv_b_proj``) + 2 N·dv·H (``o_proj``); a dense layer's SwiGLU 6 H·I; a
MoE layer's router 2 H·E_router, its shared experts 6 H·I_e·n_shared, and
6 H·I_e for each of the token's k choices that a held expert takes (the
share the layers' counters report); the pool 2 H·V. Attention: 2 N·(dn +
dr) + 2 N·dv a (query, key) pair the causal segment mask allows, L(L+1)/2
pairs in a segment of L valid tokens. A training step needs three forward
passes' worth (the backward twice the forward), whatever remat recomputes.

The held experts' products, a call of ``rows`` token-slots over
``experts`` experts: forward 6 rows·H·I operations (gate and up, 2·2I·H a
row; down, 2·I·H), their bytes the rows read and written once in bf16
(2 rows·H·2) and the experts' weights read once (experts·3·H·I·2);
backward twice the operations (both operands' gradients of both products)
and, besides, the weights' gradients written once.
"""

from __future__ import annotations

import numpy as np

from perfbench.rooflines.peaks import least_s


def _shape(cfg: dict):
    H, N, r = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    return H, N, r, dn, dr, dv


def token_flops(cfg: dict, held_share: float) -> float:
    """Forward FLOPs of one valid token outside attention's pairs."""
    H, N, r, dn, dr, dv = _shape(cfg)
    ep = cfg.get("expert_parallel", {})
    E_router = ep.get("router_experts", cfg["n_routed_experts"])
    Ie, k = cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    mla = 2 * H * N * (dn + dr) + 2 * H * (r + dr) + 2 * r * N * (dn + dv) \
        + 2 * N * dv * H
    moe = 2 * H * E_router + 6 * H * Ie * cfg["n_shared_experts"] \
        + held_share * k * 6 * H * Ie
    return (layers * mla + dense * 6 * H * cfg["intermediate_size"]
            + (layers - dense) * moe + 2 * H * cfg["vocab_size"])


def forward_flops(cfg: dict, lengths, held_share: float) -> float:
    """Forward FLOPs of segments of ``lengths`` valid tokens (any nesting
    of arrays; a packed query is its own segment); ``held_share``: the
    share of the tokens' choices that held experts take."""
    H, N, r, dn, dr, dv = _shape(cfg)
    L = np.concatenate([np.asarray(x, np.float64).reshape(-1)
                        for x in (lengths.values() if isinstance(lengths, dict)
                                  else [lengths])])
    L = L[L > 0]
    pairs = (L * (L + 1) / 2).sum()
    attn = cfg["num_hidden_layers"] * (2 * N * (dn + dr) + 2 * N * dv)
    return float(L.sum() * token_flops(cfg, held_share) + pairs * attn)


def experts_ops_bytes(rows: int, experts: int, H: int, I: int,
                      backward: bool = False):
    ops = 6.0 * rows * H * I
    moved = 2 * rows * H * 2 + experts * 3 * H * I * 2
    if backward:
        ops *= 2
        moved += rows * H * 2 + experts * 3 * H * I * 2
    return ops, moved


def experts_least(rows, experts, H, I, backward=False, **_) -> float:
    return least_s(*experts_ops_bytes(rows, experts, H, I, backward))
