"""Seeded weights of a DeepSeek-V3 decoder, made by the benchmark.

As ``core/weights.py`` does for ModernBERT: the benchmark, not the program,
makes the weights, so the reference gets the same numbers without reading
anything the program made. One ``torch.Generator`` on the card draws every
matrix in one call (normal, std 0.02), then the routers' correction biases
(normal, std ``CORRECTION_BIAS_STD``: a buffer the program does not train);
RMSNorm weights are 1. Names are HuggingFace ``DeepseekV3ForCausalLM``'s,
which the port and the reference both use, with each MoE layer's held
experts stacked (``mlp.experts.gate_up_proj`` [E, 2I, H], gate rows then
up rows; ``mlp.experts.down_proj`` [E, H, I]). ``n_routed_experts`` in the
configuration file is the count held here; the router's width is
``expert_parallel.router_experts``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

INIT_STD = 0.02
CORRECTION_BIAS_STD = 0.05


def router_experts(cfg: dict) -> int:
    return cfg.get("expert_parallel", {}).get("router_experts",
                                              cfg["n_routed_experts"])


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every tensor: init "normal", "ones" or
    "bias" (a correction bias)."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    N, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    I, Ie = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    E, Er = cfg["n_routed_experts"], router_experts(cfg)
    Is = Ie * cfg["n_shared_experts"]
    specs = [("model.embed_tokens.weight", (V, H), "normal")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        specs += [(p + "input_layernorm.weight", (H,), "ones"),
                  (a + "q_proj.weight", (N * (dn + dr), H), "normal"),
                  (a + "kv_a_proj_with_mqa.weight", (r + dr, H), "normal"),
                  (a + "kv_a_layernorm.weight", (r,), "ones"),
                  (a + "kv_b_proj.weight", (N * (dn + dv), r), "normal"),
                  (a + "o_proj.weight", (H, N * dv), "normal"),
                  (p + "post_attention_layernorm.weight", (H,), "ones")]
        m = p + "mlp."
        if i < cfg["first_k_dense_replace"]:
            specs += [(m + "gate_proj.weight", (I, H), "normal"),
                      (m + "up_proj.weight", (I, H), "normal"),
                      (m + "down_proj.weight", (H, I), "normal")]
        else:
            specs += [(m + "gate.weight", (Er, H), "normal"),
                      (m + "gate.e_score_correction_bias", (Er,), "bias"),
                      (m + "experts.gate_up_proj", (E, 2 * Ie, H), "normal"),
                      (m + "experts.down_proj", (E, H, Ie), "normal"),
                      (m + "shared_experts.gate_proj.weight", (Is, H),
                       "normal"),
                      (m + "shared_experts.up_proj.weight", (Is, H), "normal"),
                      (m + "shared_experts.down_proj.weight", (H, Is),
                       "normal")]
    specs += [("model.norm.weight", (H,), "ones"),
              ("lm_head.weight", (V, H), "normal")]
    return specs


def frozen(name: str) -> bool:
    """Tensors that are not trained (buffers)."""
    return name.endswith("e_score_correction_bias")


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` in ``dtype``; the matrices are views of
    one buffer drawn in one call, the correction biases of a second."""
    specs = param_specs(cfg)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    out = {}
    for init, std in (("normal", INIT_STD), ("bias", CORRECTION_BIAS_STD)):
        sizes = [torch.Size(s).numel() for _, s, k in specs if k == init]
        flat = torch.empty(sum(sizes), device=device, dtype=dtype)
        flat.normal_(0.0, std, generator=g)
        at = 0
        for name, shape, k in specs:
            if k == init:
                n = torch.Size(shape).numel()
                out[name] = flat[at:at + n].view(shape)
                at += n
    for name, shape, k in specs:
        if k == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
    return {name: out[name] for name, _, _ in specs}
