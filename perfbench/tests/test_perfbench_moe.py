"""The DeepSeek-V3 (MoE) V33 cell's whole run on the CPU at a tiny size
(the model in float32, every width cut): a sound run comes out correct
with no route gap, and each planted fault is caught (a step that leaves
its state unchanged, half of each batch, the experts weighed by the
biased scores, the shared experts skipped); the FLOP count and the
readers of the metrics the cell adds."""

import pytest
import torch

from perfbench.core import bench
from perfbench.tests.tiny import run

CELL = "train_v33_kanana2_moe"
TINY = dict(vocab_size=12000, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=24, num_hidden_layers=3,
            num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8, n_routed_experts=4,
            num_experts_per_tok=2, n_shared_experts=1, rope_theta=10000.0)


def tiny_moe_cell() -> bench.Cell:
    cell = bench.load_cell(CELL)
    cell.config.update(TINY)
    cell.config["expert_parallel"].update(router_experts=8, shares=2)
    cell.traffic["triplets"] = 48
    cell.config["train_v33"]["data"]["batch_size"] = 8
    cell.config["train_v33"]["model"]["dtype"] = "float32"
    return cell


def test_sound_run_is_correct():
    out = run(tiny_moe_cell())
    assert out.correct, out.checks
    assert out.checks["route_gap"]["value"] == 0.0
    assert out.checks["weight_gap"]["value"] < 1e-5
    assert out.metrics["train_tokens_per_s"] > 0 and out.attempted >= 1
    layers = out.context["moe"]
    assert len(layers) == 2 and layers[0]["held_experts"] == 4
    assert layers[0]["calls"] > 0 and layers[0]["offchip_slots"] > 0


def test_a_step_that_leaves_its_state_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out = run(tiny_moe_cell())
    assert not out.correct
    assert out.checks["update_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_caught(monkeypatch):
    from splade_tpu_torch.train import trainer

    inner = trainer.v33_loss

    def half(anchor, positive, negative, step, cfg, **kw):
        n = anchor.shape[0] // 2
        return inner(anchor[:n], positive[:n], negative[:n], step, cfg, **kw)

    monkeypatch.setattr(trainer, "v33_loss", half)
    out = run(tiny_moe_cell())
    assert not out.correct, out.checks


def test_weights_from_the_biased_scores_are_caught(monkeypatch):
    from splade_tpu_torch.models.deepseek_v3 import DeepseekV3MoE

    def route(moe, x):
        scores = torch.sigmoid(x.float() @ moe.gate.weight.float().t())
        choice = scores + moe.gate.e_score_correction_bias
        idx = torch.topk(choice, moe.top_k, dim=-1).indices
        w = choice.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * moe.scaling

    monkeypatch.setattr(DeepseekV3MoE, "route", route)
    out = run(tiny_moe_cell())
    assert not out.correct, out.checks
    # the weights' own reading catches it, whatever the loss does
    w = out.checks["weight_gap"]
    assert w["value"] > w["limit"], out.checks


def test_skipped_shared_experts_are_caught(monkeypatch):
    from splade_tpu_torch.models.deepseek_v3 import DeepseekV3MoE

    def forward(moe, x):
        flat = x.reshape(-1, x.shape[-1])
        idx, w = moe.route(flat)
        return moe.routed(flat, idx, w).to(x.dtype).view(x.shape)

    monkeypatch.setattr(DeepseekV3MoE, "forward", forward)
    out = run(tiny_moe_cell())
    assert not out.correct, out.checks


def test_flops_of_the_published_widths():
    """The per-token count at the configuration's widths: about 1.37 GFLOP
    a valid token forward with a quarter of the choices held, the pool
    0.525 of it."""
    from perfbench.rooflines.mla_moe import forward_flops, token_flops

    cfg = bench.load_cell(CELL).config
    per_token = token_flops(cfg, 0.25)
    assert per_token == pytest.approx(1.343e9, rel=1e-3)
    pool = 2 * 2048 * 128256
    assert pool / per_token == pytest.approx(0.39, abs=0.01)
    # a 256-token row adds its 32,896 causal pairs at 2·32·320 a pair, 9 layers
    got = forward_flops(cfg, {"d": [256]}, 0.25)
    assert got == pytest.approx(256 * per_token + 32896 * 9 * 20480)


def test_readers_of_the_added_metrics():
    import importlib

    from perfbench.core.trace import Trace

    trace = Trace(window_s=1.0, busy_s=0.9, device_ops=[], idle_gaps=[],
                  scope_s={"moe_experts": 0.010, "moe_experts_bwd": 0.020,
                           "moe_route": 0.001, "moe_dispatch": 0.002,
                           "moe_combine": 0.003},
                  scope_n={"moe_experts": 2, "moe_experts_bwd": 4})
    rec = dict(rows=221184, experts=32, H=2048, I=768)
    layers = [{"calls": 3, "held_slots": 3 * 221184 - 100,
               "offchip_slots": 9 * 221184, "held_experts": 32},
              {"calls": 3, "held_slots": 3 * 221184 + 100,
               "offchip_slots": 9 * 221184, "held_experts": 32}]
    ctx = {"kind": "v33", "trace": trace, "steps_traced": 2,
           "moe": layers,
           "lengths": [{"q": [64] * 4}], "window": {"window_s": 2.0},
           "model": bench.load_cell(CELL).config}
    read = {n: bench.metric_reader(n) for n in
            ("train.moe_route_ms", "train.moe_experts_roofline_pct",
             "train.moe_mfu_pct", "train.allreduce_ms")}
    assert read["train.moe_route_ms"](ctx) == pytest.approx(3.0)
    ex = importlib.import_module("perfbench.rooflines.mla_moe")
    want = 100 * (2 * ex.experts_least(**rec)
                  + 2 * ex.experts_least(backward=True, **rec)) / 0.030
    assert read["train.moe_experts_roofline_pct"](ctx) == pytest.approx(want)
    assert 0 < read["train.moe_mfu_pct"](ctx) < 1
    assert read["train.allreduce_ms"]({"allreduce_ms": [2.0, 4.0]}) == 3.0
    assert read["train.allreduce_ms"]({}) is None
    for name in ("train.moe_route_ms", "train.moe_experts_roofline_pct",
                 "train.moe_mfu_pct"):
        assert read[name]({"kind": "v33", "trace": None}) is None
    # a program without the layers' counters reads nothing
    assert read["train.moe_experts_roofline_pct"](
        {**ctx, "moe": None}) is None


def test_the_controls_read_far_above_float32_rounding():
    """control_train.py's variants of the reference against the reference
    at the tiny size: each reads a gap far above the sound run's float32
    rounding (~1e-4 at most), by the readings the cell's limits bound.
    The cell's own comparison finds the faults that its limits catch at
    any size not correct; ``control`` and ``flat_rope`` move this size's
    readings above float32 rounding but not past limits set at the
    bfloat16 rounding of the published widths, where their route gaps
    read 7 and 18 times the sound maximum (PERF.md)."""
    from perfbench import control_train

    got = control_train.moe(tiny_moe_cell(), 2 ** 31 + 5, "cpu",
                            control_train.MOE_RUNS)
    assert set(got) == set(control_train.MOE_RUNS)
    for name, r in got.items():
        worst = max(r["loss_gap"], r["grad_gap"], r["update_gap"])
        assert worst > 1e-2, (name, r)
        if name not in ("control", "flat_rope"):
            assert not r["correct"], (name, r["checks"])
    assert got["control"]["route_gap"] > 0
    assert got["biased_weights"]["route_gap"] < 1
    assert got["biased_weights"]["weight_gap"] > 1e-2


def test_route_readings_of_the_first_forward_alone():
    """``--routes-only``: the first micro-batch's forward of each variant
    against the reference's; the biased weights move the weights of
    tokens whose choices agree, and the reference against itself reads
    0 on both."""
    from perfbench import control_train

    cell = tiny_moe_cell()
    got = control_train.moe(cell, 2 ** 31 + 5, "cpu",
                            ("biased_weights", "control"), routes_only=True)
    assert set(got["biased_weights"]["checks"]) == {"route_gap",
                                                    "weight_gap"}
    assert got["biased_weights"]["weight_gap"] > 1e-2
    assert not got["biased_weights"]["correct"]
    from perfbench.drivers import train_v33_moe as d

    recipe = d._recipe(cell, "")
    rows = texts_rows(cell)
    idx = list(range(recipe["data"]["batch_size"]))
    ref = d.reference_routes(cell, 2 ** 31 + 5, rows, tok_of(cell), idx,
                             "cpu", recipe)
    micro = d.collate_rows(rows, tok_of(cell), idx, recipe["data"], "cpu")
    assert control_train.ref_routes(ref, ref, micro) == {
        "route_gap": 0.0, "weight_gap": 0.0}


def texts_rows(cell):
    from perfbench.core import texts

    tr = cell.traffic
    return texts.triplets(2 ** 31 + 5, tr["triplets"],
                          tuple(tr["query_words"]), tuple(tr["doc_words"]))


def tok_of(cell):
    from perfbench.core import texts

    return texts.CharTokenizer(cell.config["vocab_size"])


def test_route_sums_compares_the_weights_of_agreeing_tokens_only():
    from perfbench.drivers.train_v33_moe import route_sums

    idx = torch.tensor([[0, 1], [2, 3], [0, 2]])
    w = torch.tensor([[0.6, 0.4], [0.5, 0.5], [0.7, 0.3]])
    # token 0: the same experts in the other order, its weights 10% off;
    # token 1: one choice differs; token 2: padding
    other = (torch.tensor([[1, 0], [2, 1], [3, 1]]),
             torch.tensor([[0.44, 0.66], [0.9, 0.1], [0.5, 0.5]]))
    mask = torch.tensor([True, True, False])
    got = route_sums([((idx, w), other, mask)])
    assert got["route_gap"] == pytest.approx(1 / 4)
    assert got["weight_gap"] == pytest.approx(
        (0.06 ** 2 + 0.04 ** 2) ** 0.5 / (0.66 ** 2 + 0.44 ** 2) ** 0.5)
