"""The DeepSeek-V3 backbone (``models/deepseek_v3.py``) under the SPLADE-max
encoder, against the plain float32 reference ``tests/plain/deepseek_v3_plain.py``
on seeded weights at a tiny size (3 layers: 1 dense, 2 MoE; 8 routed
experts, 4 held, top 2, one shared expert): SPLADE vectors, the V33 loss
and every leaf's gradient; packed queries against unpacked rows; the
correction bias; the interleaved RoPE; the expert shares adding up to the
uncut layer; the counters; and training through the V33 ``Trainer``."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from splade_tpu_torch.config import V33Config
from splade_tpu_torch.models import deepseek_v3 as ds
from splade_tpu_torch.models.deepseek_v3 import (DeepseekV3Config,
                                                 DeepseekV3MoE, apply_rope,
                                                 deinterleave, moe_counters,
                                                 reset_moe_counters)
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.train.trainer import Trainer, make_loss_fn

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "deepseek_v3_plain", Path(__file__).parent / "plain" / "deepseek_v3_plain.py")
plain = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(plain)

LOSS = {"lambda_q": 0.01, "lambda_d": 0.003, "temperature": 1.0,
        "flops_warmup_steps": 10, "lambda_initial_ratio": 0.1}


def _plain_cfg(cfg: DeepseekV3Config) -> dict:
    return dataclasses.asdict(cfg)


def _model(seed=0, **over):
    cfg = DeepseekV3Config.tiny(**over)
    m = SpladeEncoder(cfg, device="cpu").init_weights(seed)
    with torch.no_grad():  # weights large enough that the layers matter
        for name, p in m.named_parameters():
            if not name.endswith("norm.weight"):
                p.mul_(5.0)
    return m, cfg


def _leaves(model):
    """The reference's leaves: the program's parameters and buffers under
    HF names, as f32 tensors with their own gradients."""
    out = {}
    for name, t in model.mlm.state_dict().items():
        leaf = t.detach().clone()
        if not name.endswith("e_score_correction_bias"):
            leaf.requires_grad_(True)
        out[name] = leaf
    return out


def _rows(B, S, seed, lo=3):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(4, 512, (B, S), generator=g)
    lens = torch.randint(lo, S + 1, (B,), generator=g)
    mask = (torch.arange(S)[None] < lens[:, None]).long()
    return ids * mask, mask


def test_splade_vectors_match_the_plain_reference():
    model, cfg = _model()
    ids, mask = _rows(5, 24, 1)
    with torch.no_grad():
        got, _ = model(ids, mask)
        want = plain.splade(_leaves(model), _plain_cfg(cfg), ids, mask)
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_v33_loss_and_every_gradient_match_the_plain_reference(remat):
    """The trainer's loss function (queries packed into doc-shaped rows,
    the fused pool's plain version) against the reference's unpacked
    vectors and loss; every leaf's gradient within float32 rounding."""
    model, cfg = _model(remat=remat)
    B, Sq, Sd = 5, 8, 24
    q_ids, q_mask = _rows(B, Sq, 2)
    p_ids, p_mask = _rows(B, Sd, 3)
    n_ids, n_mask = _rows(B, Sd, 4)
    micro = {"query_input_ids": q_ids, "query_attention_mask": q_mask,
             "positive_input_ids": p_ids, "positive_attention_mask": p_mask,
             "negative_input_ids": n_ids, "negative_attention_mask": n_mask}
    loss_fn = make_loss_fn(model, V33Config.from_dict({"loss": LOSS}).loss,
                           1, packed_query=True)
    loss, _ = loss_fn(micro, 3)
    loss.backward()
    p = _leaves(model)
    pc = _plain_cfg(cfg)
    want = plain.v33_loss(plain.splade(p, pc, q_ids, q_mask),
                          plain.splade(p, pc, p_ids, p_mask),
                          plain.splade(p, pc, n_ids, n_mask)[:, None], 3,
                          LOSS)
    want.backward()
    torch.testing.assert_close(loss.detach(), want.detach(), rtol=1e-5,
                               atol=1e-6)
    grads = dict(model.mlm.named_parameters())
    assert set(grads) == {n for n, t in p.items() if t.requires_grad}
    moved = 0
    for name, param in grads.items():
        ref = p[name].grad
        got = param.grad
        if ref is None or float(ref.abs().max()) == 0.0:
            # experts no token chose in this batch
            assert got is None or float(got.abs().max()) == 0.0, name
            continue
        moved += 1
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 2e-4 * scale, name
    assert moved >= len(grads) - 4


def test_packed_queries_give_the_vectors_of_unpacked_rows():
    model, _ = _model(seed=3)
    q_ids, q_mask = _rows(7, 8, 5, lo=1)
    d_ids, d_mask = _rows(2, 24, 6)
    with torch.no_grad():
        (q_packed, _), (d_packed, _) = model.forward_packed_qd(
            q_ids, q_mask, d_ids, d_mask)
        q_alone, _ = model(q_ids, q_mask)
        d_alone, _ = model(d_ids, d_mask)
    torch.testing.assert_close(q_packed, q_alone, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_packed, d_alone, rtol=1e-5, atol=1e-5)


def test_the_correction_bias_changes_the_choice_but_never_the_weights():
    model, _ = _model(seed=4)
    moe = next(m for m in model.modules() if isinstance(m, DeepseekV3MoE))
    x = torch.randn(256, 64, generator=torch.Generator().manual_seed(0))
    bias = moe.gate.e_score_correction_bias
    with torch.no_grad():
        bias.zero_()
        idx0, w0 = moe.route(x)
        bias[torch.arange(8) % 2 == 1] = 0.5   # odd experts favoured
        idx1, w1 = moe.route(x)
        scores = torch.sigmoid(x @ moe.gate.weight.t())
    assert not torch.equal(idx0.sort(-1).values, idx1.sort(-1).values)
    assert bool((idx1 % 2 == 1).all())
    for idx, w in ((idx0, w0), (idx1, w1)):
        s = scores.gather(1, idx)
        want = s / (s.sum(-1, keepdim=True) + 1e-20) * 2.448
        torch.testing.assert_close(w, want, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(w.sum(-1), torch.full((256,), 2.448),
                                   rtol=1e-5, atol=1e-6)


def test_the_interleaved_rope_matches_a_direct_pairwise_rotation():
    g = torch.Generator().manual_seed(7)
    B, S, N, d = 2, 11, 3, 8
    q = torch.randn(B, S, N, d, generator=g, dtype=torch.float64)
    k = torch.randn(B, S, 1, d, generator=g, dtype=torch.float64)
    pos = torch.randint(0, 40, (B, S), generator=g)
    cos, sin = ds.rope_cos_sin(64, d, 1e6)
    cos, sin = cos.double()[pos], sin.double()[pos]
    got_q = apply_rope(q, cos, sin)
    got_k = apply_rope(k, cos, sin)
    # the direct rotation of each pair (2i, 2i+1), gathered into halves
    want_q = deinterleave(plain.rope_pairs(q, pos, 1e6).double())
    torch.testing.assert_close(got_q, want_q, rtol=1e-6, atol=1e-6)
    # dot products of q and k are those of the pairwise rotation
    got = torch.einsum("bqnd,bkd->bnqk", got_q, got_k[:, :, 0])
    want = torch.einsum("bqnd,bkd->bnqk", plain.rope_pairs(q, pos, 1e6),
                        plain.rope_pairs(k, pos, 1e6)[:, :, 0])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # without the interleave the pairs are (i, i + d/2): another rotation
    flat = apply_rope(q, cos, sin, interleave=False)
    assert float((deinterleave(flat) - got_q).abs().max()) > 1e-2


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Four shares of the routed experts: their routed parts, with the
    shared expert counted once, give the uncut reference layer."""
    whole = DeepseekV3Config.tiny(expert_shares=1)
    g = torch.Generator().manual_seed(11)
    moe_whole = DeepseekV3MoE(whole)
    with torch.no_grad():
        for p in moe_whole.parameters():
            p.normal_(0.0, 0.3, generator=g)
        moe_whole.gate.e_score_correction_bias.normal_(0.0, 0.1, generator=g)
    state = moe_whole.state_dict()
    x = torch.randn(40, 64, generator=g)
    total = torch.zeros(40, 64)
    with torch.no_grad():
        for share in range(4):
            cfg = DeepseekV3Config.tiny(expert_shares=4, expert_share=share)
            part = DeepseekV3MoE(cfg)
            lo = share * 2
            part.load_state_dict({
                **state,
                "experts.gate_up_proj": state["experts.gate_up_proj"][lo:lo + 2],
                "experts.down_proj": state["experts.down_proj"][lo:lo + 2]})
            idx, w = part.route(x)
            total += part.routed(x, idx, w)
        total += part.shared_experts(x)
        p = {"layers.0.mlp." + k: v for k, v in state.items()}
        want = plain.moe(p, "layers.0.", _plain_cfg(whole), x[None])[0]
        torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(moe_whole(x[None])[0], want, rtol=1e-5,
                                   atol=1e-5)


def test_the_counters_count_held_and_off_card_slots():
    model, cfg = _model(seed=5)
    ids, mask = _rows(3, 16, 8)
    reset_moe_counters(model)
    with torch.no_grad():
        model(ids, mask)
        model(ids, mask)
    counts = moe_counters(model)
    assert len(counts) == cfg.num_hidden_layers - 1
    T = 3 * 16
    for c in counts:
        assert c["calls"] == 2 and c["held_experts"] == 4
        assert c["held_slots"] + c["offchip_slots"] == 2 * T * 2
        assert 0 < c["held_slots"] < 2 * T * 2
        assert c["max_load"] >= c["mean_load"] == c["held_slots"] / 8
    reset_moe_counters(model)
    assert moe_counters(model)[0]["calls"] == 0


#: kakaocorp/kanana-2-30b-a3b-instruct-2601's config.json, the keys the
#: port reads
KANANA = dict(
    vocab_size=128256, hidden_size=2048, intermediate_size=6144,
    moe_intermediate_size=768, num_hidden_layers=48, num_attention_heads=32,
    kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=128,
    n_shared_experts=2, num_experts_per_tok=6, first_k_dense_replace=1,
    moe_layer_freq=1, n_group=1, topk_group=1, norm_topk_prob=True,
    routed_scaling_factor=2.448, scoring_func="sigmoid",
    topk_method="noaux_tc", rms_norm_eps=1e-6, rope_theta=1e6,
    rope_interleave=True, rope_scaling=None, max_position_embeddings=32768,
    attention_bias=False, tie_word_embeddings=False,
    model_type="deepseek_v3")


def test_from_hf_dict_reads_the_published_config():
    kanana = DeepseekV3Config.from_hf_dict(KANANA, vocab_size=1000,
                                           remat=True)
    assert (kanana.hidden_size, kanana.qk_head_dim, kanana.n_routed_experts,
            kanana.num_hidden_layers, kanana.vocab_size, kanana.remat) == (
        2048, 192, 128, 48, 1000, True)
    with pytest.raises(ValueError, match="attention_impl"):
        DeepseekV3Config.from_hf_dict(KANANA, attention_impl="splash")


@pytest.mark.parametrize("over", [dict(q_lora_rank=64), dict(n_group=2),
                                  dict(scoring_func="softmax"),
                                  dict(expert_shares=3)])
def test_unsupported_configs_are_refused(over):
    with pytest.raises(ValueError):
        DeepseekV3Config.tiny(**over)


def test_init_weights_seeds_the_correction_bias_and_no_bias_leaf():
    model = SpladeEncoder(DeepseekV3Config.tiny(), device="cpu")
    model.init_weights(0)
    biases = [b for n, b in model.named_buffers()
              if n.endswith("e_score_correction_bias")]
    assert len(biases) == 2
    assert 0.02 < float(biases[0].std()) < 0.1
    assert not [n for n, _ in model.named_parameters() if n.endswith("bias")]
    assert model.device == torch.device("cpu")
    assert model.mlm.decoder_weights()[1] is None


def test_the_v33_trainer_trains_the_deepseek_backbone(tmp_path):
    """Two optimizer steps of the V33 Trainer (collator, packed queries,
    the pool, AdamW with clipping) on the backbone: the loss is finite,
    parameters move, the correction bias does not."""
    from splade_tpu_torch.data import TripletCollator

    from test_data import FakeTokenizer

    class Tok(FakeTokenizer):
        def __len__(self):
            return 512

    rng = np.random.default_rng(0)
    words = ["가나", "다라", "마바", "사아", "자차"]

    def text(n):
        return " ".join(rng.choice(words, n))

    rows = [{"query": text(2), "positive": text(6), "negative": text(6)}
            for _ in range(16)]
    cfg = V33Config.from_dict({
        "model": {"dtype": "float32"}, "mesh": {"num_data": 1},
        "loss": {"flops_warmup_steps": 10},
        "data": {"batch_size": 4, "query_max_length": 8,
                 "doc_max_length": 16},
        "training": {"gradient_accumulation_steps": 2,
                     "learning_rate": 1e-3, "num_epochs": 1,
                     "log_every_n_steps": 1, "output_dir": str(tmp_path)}})
    model = SpladeEncoder(DeepseekV3Config.tiny(remat=True),
                          device="cpu").init_weights(0)
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    collator = TripletCollator(Tok(), query_max_length=8, doc_max_length=16)
    trainer = Trainer(cfg, model, rows, collator, device="cpu")
    out = trainer.train_epoch(1)
    assert trainer.state.step == 2 and np.isfinite(out["loss"])
    after = model.state_dict()
    moved = [n for n in before if not torch.equal(before[n], after[n])]
    assert "mlm.lm_head.weight" in moved
    assert "mlm.model.layers.1.mlp.experts.gate_up_proj" in moved
    assert not [n for n in moved if n.endswith("e_score_correction_bias")]


@pytest.mark.parametrize("rows", [1, 2, 5])
def test_blocked_attention_matches_autograd_through_the_expression(rows):
    """The attention's blocks of rows, whose backward recomputes each
    block's probabilities, against autograd through the unblocked
    expression (causal, segment and padding mask), in float64."""
    g = torch.Generator().manual_seed(rows)
    B, S, N, D, Dv = 5, 12, 3, 6, 4
    q, k = (torch.randn(B, S, N, D, generator=g, dtype=torch.float64)
            for _ in range(2))
    v = torch.randn(B, S, N, Dv, generator=g, dtype=torch.float64)
    _, mask = _rows(B, S, 9, lo=1)
    seg = (torch.arange(S) >= 7).long().expand(B, S)
    bias = ds.attention_bias(mask, seg).double()
    w = torch.randn(B, S, N, Dv, generator=g, dtype=torch.float64)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        (out * w).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    def plain(q, k, v):
        p = torch.softmax(torch.einsum("bqnd,bknd->bnqk", q, k) * 0.3 + bias,
                          -1)
        return torch.einsum("bnqk,bknd->bqnd", p, v)

    got = grads(lambda *t: ds._Attention.apply(*t, bias, 0.3, rows))
    want = grads(plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
