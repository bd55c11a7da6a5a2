"""DeepSeek-V3 decoder as a SPLADE-max backbone, in PyTorch.

The architecture of HuggingFace's ``DeepseekV3ForCausalLM`` (``model_type``
``deepseek_v3``, e.g. ``kakaocorp/kanana-2-30b-a3b-instruct-2601``), whose
parameter names it uses. Each layer, for a row of tokens at positions p
with segment ids:

    h   = x + o_proj(MLA(input_layernorm(x)))
    out = h + FFN(post_attention_layernorm(h))

RMSNorm (computed in float32, eps ``rms_norm_eps``). The first
``first_k_dense_replace`` layers' FFN is a dense SwiGLU
``down(silu(gate(x)) * up(x))``; the later ones are a mixture of experts.

Multi-head latent attention without a q low-rank projection: ``q_proj``
gives N heads of ``qk_nope_head_dim`` + ``qk_rope_head_dim``;
``kv_a_proj_with_mqa`` gives the latent c (``kv_lora_rank``) and one shared
k_pe head; ``kv_b_proj(kv_a_layernorm(c))`` gives each head's k_nope and v.
q_pe and k_pe are rotated by RoPE (theta ``rope_theta``) in HF's
interleaved convention: the pairs (2i, 2i+1) are first gathered into
halves, then turned by p·theta^(-2i/d) in the rotate-half form (q and k
alike, so q·k is that of the pairwise rotation). k_pe is broadcast to the
N heads; scores are q·k / sqrt(qk_head_dim) under the mask causal ∧ same
segment ∧ key valid, in float32, and softmax · v goes to ``o_proj``. The
attention is plain math (``attention_impl`` "sdpa"): the splash kernels
take 64-wide heads only.

The mixture of experts: sigmoid scores of the router (``mlp.gate``, float32
products over every routed expert), the top ``num_experts_per_tok`` of the
scores plus the correction bias ``e_score_correction_bias`` chosen
(``noaux_tc``), the chosen unbiased scores normalised to sum 1 (+1e-20)
and scaled by ``routed_scaling_factor``; the output is the weighted sum of
the chosen experts' SwiGLUs plus the shared experts (one SwiGLU
``n_shared_experts`` times as wide). The correction bias is a buffer: it
is not trained (DeepSeek's bias-update rule is a pre-training mechanism
and is left out), and there is no auxiliary loss.

Expert parallelism: a layer holds one of ``expert_shares`` equal shares of
the routed experts (share ``expert_share``). Its router keeps every expert
and the top k; the layer computes its held experts' part for the tokens
routed to them and drops the rest (on one card nothing stands in for the
absent shares). The held slots are sorted by expert; one host read of the
held experts' loads sizes the products. On the card the products run as
grouped bfloat16 products over the held experts (``torch._grouped_mm``,
each expert's rows padded to ``GROUP_ALIGN``); on the CPU a plain loop
over the held experts computes the same thing. Each MoE layer keeps
counters on the device, with no sync: slots routed to held experts, slots
routed off the card, the largest load of a held expert (``moe_counters``).

The model computes in the dtype of its parameters, or bf16 under
``torch.autocast`` over float32 parameters, as the V33 trainer runs it;
``remat`` recomputes each layer in the backward pass. The SPLADE pool runs
on ``encode``'s final-normed states with the untied ``lm_head`` and no
bias (``head_transform`` is the identity). Profiler ranges ``mla.attention``,
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` mark
the layer's parts.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

# Large finite negative for additive masks (as models/modernbert.py)
MASK_NEG = -1e30
#: rows of each held expert's group in the grouped products are padded to
#: a multiple of this (16-byte aligned bf16 groups for every operand)
GROUP_ALIGN = 16
#: bytes of one block's float32 scores in the attention (512 MiB: 64 rows
#: of 32 heads at S = 256)
ATTN_BLOCK_BYTES = 1 << 29
#: std of the seeded correction bias ``init_weights`` draws (published
#: checkpoints carry trained values; a seeded one makes it change choices)
CORRECTION_BIAS_STD = 0.05


@dataclass(frozen=True)
class DeepseekV3Config:
    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 6144
    moe_intermediate_size: int = 768
    num_hidden_layers: int = 48
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 128
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.448
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    rope_interleave: bool = True
    rope_scaling: Optional[dict] = None
    max_position_embeddings: int = 32768
    pad_token_id: int = 0
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    expert_shares: int = 1
    """Equal shares the routed experts are divided into (expert
    parallelism over that many cards)."""
    expert_share: int = 0
    """The share this model holds: experts [share·E/shares, (share+1)·E/shares)."""
    remat: bool = False
    """Recompute each layer's activations in the backward pass."""
    attention_impl: str = "sdpa"
    """Only 'sdpa' (plain math): the splash kernels take 64-wide heads."""

    def __post_init__(self) -> None:
        unsupported = {
            "q_lora_rank": self.q_lora_rank is not None,
            "n_group": self.n_group != 1 or self.topk_group != 1,
            "scoring_func": self.scoring_func != "sigmoid",
            "topk_method": self.topk_method != "noaux_tc",
            "attention_bias": self.attention_bias,
            "tie_word_embeddings": self.tie_word_embeddings,
            "rope_scaling": self.rope_scaling is not None,
            "attention_impl": self.attention_impl != "sdpa",
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"DeepseekV3Config: unsupported {bad} (the port "
                             "runs q without a low-rank projection, one "
                             "expert group, sigmoid noaux_tc routing, no "
                             "attention bias, untied embeddings, no RoPE "
                             "scaling, plain-math attention)")
        if (self.n_routed_experts % self.expert_shares
                or not 0 <= self.expert_share < self.expert_shares):
            raise ValueError(f"{self.n_routed_experts} routed experts do not "
                             f"split into share {self.expert_share} of "
                             f"{self.expert_shares}")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held_experts(self) -> range:
        n = self.n_routed_experts // self.expert_shares
        return range(self.expert_share * n, (self.expert_share + 1) * n)

    def is_moe_layer(self, layer_id: int) -> bool:
        return (layer_id >= self.first_k_dense_replace
                and layer_id % self.moe_layer_freq == 0)

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any], **over: Any) -> "DeepseekV3Config":
        """The fields an HF ``config.json`` of ``model_type`` deepseek_v3
        names (``qk_head_dim``, ``head_dim`` and the rest are implied or
        ignored), then ``over``."""
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: d[k] for k in keys if k in d}
        kw.update(over)
        return cls(**kw)

    @classmethod
    def tiny(cls, **over: Any) -> "DeepseekV3Config":
        """Small config for unit tests: 3 layers (1 dense, 2 MoE), 8 routed
        experts of which 4 are held, top 2, one shared expert, every width
        cut in proportion."""
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=192,
                    moe_intermediate_size=24, num_hidden_layers=3,
                    num_attention_heads=4, kv_lora_rank=16,
                    qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                    n_routed_experts=8, n_shared_experts=1,
                    num_experts_per_tok=2, expert_shares=2, expert_share=0,
                    rope_theta=10000.0)
        base.update(over)
        return cls(**base)


class RMSNorm(nn.Module):
    """x / rms(x) · weight, computed in float32 (HF's DeepseekV3RMSNorm:
    the normed value returns in the input's dtype before the weight)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(x.dtype)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)): the dense FFN and the shared experts."""

    def __init__(self, hidden: int, inner: int):
        super().__init__()
        self.gate_proj = nn.Linear(hidden, inner, bias=False)
        self.up_proj = nn.Linear(hidden, inner, bias=False)
        self.down_proj = nn.Linear(inner, hidden, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def rope_cos_sin(seq_len: int, dim: int, theta: float,
                 device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos/sin tables [S, dim] in the rotate-half layout:
    concat(freqs, freqs), freqs[p, i] = p · theta^(-2i/dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    emb = torch.cat([torch.outer(pos, inv)] * 2, dim=-1)
    return emb.cos(), emb.sin()


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d]: the pairs (2i, 2i+1) gathered into halves
    (x0, x2, ..., x1, x3, ...), as HF's interleaved RoPE does first."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleave: bool = True) -> torch.Tensor:
    """x [B, S, N, d]; cos/sin [S, d] or [B, S, d] (per-row positions).
    HF's ``apply_rotary_pos_emb_interleave`` when ``interleave``: the
    result is in the gathered-halves layout (for q and k alike). In x's
    dtype."""
    if interleave:
        x = deinterleave(x)
    d2 = x.shape[-1] // 2
    rotated = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return (x * c + rotated * s).to(x.dtype)


def attention_bias(attention_mask: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[B, 1, S, S] float32 additive mask: a query at index i sees keys j
    <= i of its own segment that are valid; 0 there, -1e30 elsewhere (a
    padded query with no such key gets a finite uniform row)."""
    B, S = attention_mask.shape
    idx = torch.arange(S, device=attention_mask.device)
    ok = attention_mask.to(torch.bool)[:, None, :] & (
        idx[None, :, None] >= idx[None, None, :])
    if segment_ids is not None:
        ok = ok & (segment_ids[:, :, None] == segment_ids[:, None, :])
    return torch.where(ok, 0.0, MASK_NEG).to(torch.float32)[:, None]


def _scores(q, k, bias, scale) -> torch.Tensor:
    """Softmax rows [b, N, S, S] of q·k · scale + bias, in float32 (or
    q's dtype where that is wider)."""
    scores = torch.einsum("bqnd,bknd->bnqk", q, k).to(
        torch.promote_types(q.dtype, torch.float32))
    return torch.softmax(scores * scale + bias, dim=-1)


class _Attention(torch.autograd.Function):
    """softmax(q·k · scale + bias) · v in blocks of rows, saving q, k, v
    and the bias only: the backward recomputes each block's probabilities,
    so no [B, N, S, S] tensor outlives its block. The operations and their
    dtypes are those of autograd through the unblocked expression."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, rows: int):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.rows = scale, rows
        return torch.cat([torch.einsum(
            "bnqk,bknd->bqnd", _scores(q[i:i + rows], k[i:i + rows],
                                       bias[i:i + rows], scale).to(v.dtype),
            v[i:i + rows]) for i in range(0, q.shape[0], rows)])

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rows = ctx.rows
        for i in range(0, q.shape[0], rows):
            sl = slice(i, i + rows)
            probs = _scores(q[sl], k[sl], bias[sl], ctx.scale)
            g = d_out[sl].to(v.dtype)
            dv[sl] = torch.einsum("bnqk,bqnd->bknd", probs.to(v.dtype), g)
            dp = torch.einsum("bqnd,bknd->bnqk", g, v[sl]).to(probs.dtype)
            ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
            ds = (ds * ctx.scale).to(q.dtype)
            dq[sl] = torch.einsum("bnqk,bknd->bqnd", ds, k[sl])
            dk[sl] = torch.einsum("bnqk,bqnd->bknd", ds, q[sl])
        return dq, dk, dv, None, None, None


def attention(q, k, v, bias, scale: float) -> torch.Tensor:
    """q, k [B, S, N, D], v [B, S, N, Dv], bias [B, 1, S, S] float32 ->
    [B, S, N, Dv]: scores in float32, softmax, probabilities in v's dtype
    times v; blocks of rows whose float32 scores take ATTN_BLOCK_BYTES."""
    B, S, N, _ = q.shape
    rows = max(1, ATTN_BLOCK_BYTES // (N * S * S * 4))
    return _Attention.apply(q, k, v, bias, scale, rows)


class DeepseekV3Attention(nn.Module):
    """Multi-head latent attention, q without a low-rank projection."""

    def __init__(self, config: DeepseekV3Config):
        super().__init__()
        H, N = config.hidden_size, config.num_attention_heads
        self.n_heads = N
        self.nope, self.rope = config.qk_nope_head_dim, config.qk_rope_head_dim
        self.v_dim = config.v_head_dim
        self.lora = config.kv_lora_rank
        self.interleave = config.rope_interleave
        self.scale = config.qk_head_dim ** -0.5
        self.q_proj = nn.Linear(H, N * config.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(H, self.lora + self.rope,
                                            bias=False)
        self.kv_a_layernorm = RMSNorm(self.lora, config.rms_norm_eps)
        self.kv_b_proj = nn.Linear(self.lora, N * (self.nope + self.v_dim),
                                   bias=False)
        self.o_proj = nn.Linear(N * self.v_dim, H, bias=False)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        B, S, _ = x.shape
        N = self.n_heads
        q = self.q_proj(x).view(B, S, N, self.nope + self.rope)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([self.lora, self.rope],
                                                   dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(
            B, S, N, self.nope + self.v_dim)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin, self.interleave)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin, self.interleave)
        q = torch.cat([q_nope, q_pe.to(q_nope.dtype)], dim=-1)
        k = torch.cat([k_nope, k_pe.to(k_nope.dtype).expand(
            B, S, N, self.rope)], dim=-1)
        with record_function("mla.attention"):
            out = attention(q, k, v, bias, self.scale)
        return self.o_proj(out.reshape(B, S, N * self.v_dim))


class TopkRouter(nn.Module):
    """Router weights over every routed expert and the correction bias
    (a buffer, not trained)."""

    def __init__(self, config: DeepseekV3Config):
        super().__init__()
        E = config.n_routed_experts
        self.weight = nn.Parameter(torch.empty(E, config.hidden_size))
        self.register_buffer("e_score_correction_bias", torch.zeros(E))


class HeldExperts(nn.Module):
    """The held routed experts' SwiGLU weights, stacked:
    ``gate_up_proj`` [E_held, 2I, H] (gate rows, then up rows) and
    ``down_proj`` [E_held, H, I]."""

    def __init__(self, n: int, hidden: int, inner: int):
        super().__init__()
        self.inner = inner
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * inner, hidden))
        self.down_proj = nn.Parameter(torch.empty(n, hidden, inner))


def grouped_swiglu(xs: torch.Tensor, sizes: List[int], gate_up: torch.Tensor,
                   down: torch.Tensor) -> torch.Tensor:
    """[n, H] rows sorted by held expert (``sizes[e]`` rows for expert e)
    -> each row's expert SwiGLU, [n, H]. On the card: two grouped bf16
    products over the held experts (each group padded to GROUP_ALIGN
    rows of zeros); on the CPU: a plain loop over the held experts, in the
    dtype of ``xs``."""
    inner = gate_up.shape[1] // 2
    if not xs.is_cuda:
        outs, at = [], 0
        for e, n in enumerate(sizes):
            g, u = F.linear(xs[at:at + n], gate_up[e].to(xs.dtype)).split(
                inner, dim=-1)
            outs.append(F.linear(F.silu(g) * u, down[e].to(xs.dtype)))
            at += n
        return torch.cat(outs) if outs else xs[:0]
    padded = [-(-n // GROUP_ALIGN) * GROUP_ALIGN for n in sizes]
    dest = None
    xb = xs.to(torch.bfloat16)
    if padded != sizes:
        # row j of expert e moves by (padded start - start) of e
        shift = [p0 - s0 for p0, s0 in zip(
            itertools.accumulate([0] + padded[:-1]),
            itertools.accumulate([0] + sizes[:-1]))]
        per_row = torch.repeat_interleave(
            torch.tensor(shift, device=xs.device),
            torch.tensor(sizes, device=xs.device), output_size=xs.shape[0])
        dest = torch.arange(xs.shape[0], device=xs.device) + per_row
        xb = xb.new_zeros(sum(padded), xb.shape[1]).index_copy(0, dest, xb)
    offs = torch.tensor(list(itertools.accumulate(padded)),
                        dtype=torch.int32, device=xs.device)
    gu = torch._grouped_mm(xb, gate_up.to(torch.bfloat16).transpose(-2, -1),
                           offs=offs)
    g, u = gu.split(inner, dim=-1)
    act = F.silu(g) * u
    out = torch._grouped_mm(act, down.to(torch.bfloat16).transpose(-2, -1),
                            offs=offs)
    return out if dest is None else out[dest]


class DeepseekV3MoE(nn.Module):
    """The routed experts this model holds plus the shared experts."""

    def __init__(self, config: DeepseekV3Config):
        super().__init__()
        self.top_k = config.num_experts_per_tok
        self.norm_topk = config.norm_topk_prob
        self.scaling = config.routed_scaling_factor
        held = config.held_experts
        self.first, self.n_held = held.start, len(held)
        self.gate = TopkRouter(config)
        self.experts = HeldExperts(self.n_held, config.hidden_size,
                                   config.moe_intermediate_size)
        self.shared_experts = SwiGLU(
            config.hidden_size,
            config.moe_intermediate_size * config.n_shared_experts)
        # device counters: held slots, off-card slots, largest held load
        self.load_stats: Optional[torch.Tensor] = None
        self.calls = 0

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[T, H] -> (chosen experts [T, k] int64, their weights [T, k]
        float32): sigmoid scores in float32, the top k of score + bias,
        weighed by the unbiased scores, normalised and scaled."""
        with torch.autocast(x.device.type, enabled=False):
            scores = torch.sigmoid(F.linear(x.to(torch.float32),
                                            self.gate.weight.to(torch.float32)))
        choice = scores + self.gate.e_score_correction_bias
        idx = torch.topk(choice, self.top_k, dim=-1, sorted=False).indices
        w = scores.gather(1, idx)
        if self.norm_topk:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * self.scaling

    def _count(self, counts: torch.Tensor) -> None:
        held = counts[:self.n_held]
        now = torch.stack([held.sum(), counts[self.n_held], held.max()])
        if self.load_stats is None or self.load_stats.device != now.device:
            self.load_stats = torch.zeros_like(now)
        self.load_stats[:2] += now[:2]
        self.load_stats[2] = torch.maximum(self.load_stats[2], now[2])
        self.calls += 1

    def routed(self, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
        """[T, H] -> the held experts' weighted part, [T, H] float32 (rows
        of tokens routed to no held expert are 0)."""
        T, H = x.shape
        E, k = self.n_held, self.top_k
        with record_function("moe.dispatch"):
            local = idx.reshape(-1) - self.first
            key = torch.where((local >= 0) & (local < E), local,
                              torch.full_like(local, E))
            counts = torch.bincount(key, minlength=E + 1)
            self._count(counts)
            order = torch.argsort(key, stable=True)
            sizes = counts[:E].tolist()      # the one host read: sizes
            order = order[:sum(sizes)]
            token = torch.div(order, k, rounding_mode="floor")
            # on the card the experts compute in bf16: gather bf16 rows
            xs = (x.to(torch.bfloat16) if x.is_cuda else x)[token]
            ws = w.reshape(-1)[order]
        with record_function("moe.experts"):
            ys = grouped_swiglu(xs, sizes, self.experts.gate_up_proj,
                                self.experts.down_proj)
        with record_function("moe.combine"):
            return torch.zeros(T, H, dtype=torch.float32,
                               device=x.device).index_add(
                0, token, ys.to(torch.float32) * ws[:, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        with record_function("moe.route"):
            idx, w = self.route(flat)
        out = self.routed(flat, idx, w).to(x.dtype).view(shape)
        return out + self.shared_experts(x)


class DeepseekV3DecoderLayer(nn.Module):
    def __init__(self, config: DeepseekV3Config, layer_id: int):
        super().__init__()
        self.self_attn = DeepseekV3Attention(config)
        self.mlp = (DeepseekV3MoE(config) if config.is_moe_layer(layer_id)
                    else SwiGLU(config.hidden_size, config.intermediate_size))
        self.input_layernorm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps)

    def forward(self, x, bias, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), bias, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class _Model(nn.Module):
    def __init__(self, config: DeepseekV3Config):
        super().__init__()
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.ModuleList(DeepseekV3DecoderLayer(config, i)
                                    for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)


class DeepseekV3ForCausalLM(nn.Module):
    """Decoder + untied LM head under HF names (``model.layers.{i}...``,
    ``lm_head.weight``), with the methods ``SpladeEncoder`` calls on a
    backbone: ``encode``, ``head_transform`` (the identity),
    ``decoder_weights`` and ``project_vocab``."""

    def __init__(self, config: DeepseekV3Config):
        super().__init__()
        self.config = config
        self.model = _Model(config)
        self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                 bias=False)

    def encode(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               positions: Optional[torch.Tensor] = None,
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, S] ids -> [B, S, H] final-normed hidden states. positions
        [B, S] (None = arange(S)) and segment_ids [B, S] (None = one
        segment a row) serve sequence packing."""
        cfg = self.config
        S = input_ids.shape[1]
        x = self.model.embed_tokens(input_ids)
        bias = attention_bias(attention_mask, segment_ids)
        cos, sin = rope_cos_sin(S, cfg.qk_rope_head_dim, cfg.rope_theta,
                                input_ids.device)
        if positions is not None:
            cos, sin = cos[positions], sin[positions]
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.model.layers:
            if remat:
                x = checkpoint(layer, x, bias, cos, sin, use_reentrant=False)
            else:
                x = layer(x, bias, cos, sin)
        return self.model.norm(x)

    def head_transform(self, hidden: torch.Tensor) -> torch.Tensor:
        """No head transform: the pool reads the final-normed states."""
        return hidden

    def decoder_weights(self) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self.lm_head.weight, None

    def project_vocab(self, transformed: torch.Tensor) -> torch.Tensor:
        return self.lm_head(transformed)


def moe_layers(model: nn.Module) -> List[DeepseekV3MoE]:
    return [m for m in model.modules() if isinstance(m, DeepseekV3MoE)]


def moe_counters(model: nn.Module) -> List[Dict[str, float]]:
    """Per MoE layer, since the last reset: its calls (a remat recompute
    is a call), slots routed to held experts, slots routed off the card,
    the largest and the mean load of a held expert in one call, and the
    held experts. Reading them waits for the card."""
    out = []
    for m in moe_layers(model):
        s = (m.load_stats.tolist() if m.load_stats is not None
             else [0, 0, 0])
        calls = max(m.calls, 1)
        out.append({"calls": m.calls, "held_slots": s[0],
                    "offchip_slots": s[1], "max_load": s[2],
                    "mean_load": s[0] / (calls * m.n_held),
                    "held_experts": m.n_held})
    return out


def reset_moe_counters(model: nn.Module) -> None:
    for m in moe_layers(model):
        m.load_stats, m.calls = None, 0

