"""The data-parallel V33 cell's whole run on the CPU at a tiny size: four
ranks, one process each, over gloo (the model in float32). A sound run
comes out correct with every rank's tokens counted; a fault planted in
rank 0 (this process) is caught: a step that leaves its state unchanged,
half of each batch left out, the exchange between the ranks left out."""

import pytest
import torch

from perfbench.core import bench
from perfbench.tests.tiny import TINY_MODEL, run

CELL = "train_v33_dp4"


def tiny_dp_cell() -> bench.Cell:
    cell = bench.load_cell(CELL)
    cell.config.update(TINY_MODEL)
    cell.traffic["triplets"] = 4 * 48
    recipe = cell.config["train_v33"]
    recipe["data"]["batch_size"] = 4
    recipe["training"]["gradient_accumulation_steps"] = 2
    recipe["model"]["dtype"] = "float32"
    # the splash kernels' plain version is slow on the CPU; the driver's
    # path is the same on either route
    recipe["model"]["attention_impl"] = "sdpa"
    return cell


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_sound_run_at_world_4_is_correct():
    cell = tiny_dp_cell()
    assert cell.chips == 4 and cell.traffic["ranks"] == 4
    out = run(cell, seconds=2.0, trace=True)
    assert out.correct, out.checks
    assert out.checks["rows_unknown"]["value"] == 0
    # every rank's tokens: four ranks of 4 x 2 triplets a step
    steps = out.attempted
    assert out.metrics["train_tokens_per_s"] * out.context["window"][
        "window_s"] > 3.5 * out.context["window"]["tokens"]
    assert steps >= 1 and len(out.context["allreduce_ms"]) == steps
    assert bench.metric_reader("train.allreduce_ms")(out.context) > 0


def test_a_rank_whose_step_leaves_its_state_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out = run(tiny_dp_cell())
    assert not out.correct
    assert out.checks["update_gap"]["value"] == pytest.approx(1.0)


def test_a_rank_that_takes_half_its_batch_is_caught(monkeypatch):
    from splade_tpu_torch.train import trainer

    inner = trainer.v33_loss

    def half(anchor, positive, negative, step, cfg, **kw):
        n = anchor.shape[0] // 2
        return inner(anchor[:n], positive[:n], negative[:n], step, cfg, **kw)

    monkeypatch.setattr(trainer, "v33_loss", half)
    out = run(tiny_dp_cell())
    assert not out.correct, out.checks


def test_a_rank_that_keeps_its_own_gradients_is_caught(monkeypatch):
    """Rank 0 joins the all-reduce (so the other ranks finish theirs) but
    steps on its own gradients: the exchange between the cards left out
    on its side."""
    from splade_tpu_torch.parallel.mesh import GradReducer

    inner = GradReducer.__call__

    def own(self, grads):
        inner(self, [g.clone() for g in grads])

    monkeypatch.setattr(GradReducer, "__call__", own)
    out = run(tiny_dp_cell())
    assert not out.correct, out.checks
    assert out.checks["grad_gap"]["value"] > out.checks["grad_gap"]["limit"]


def test_the_controls_are_caught_by_the_cells_comparison():
    """control_train.py's variants at the tiny size (every rank's rows in
    one process): each reads far above float32 rounding and the cell's own
    comparison finds it not correct."""
    from perfbench import control_train

    got = control_train.dp(tiny_dp_cell(), 2 ** 31 + 7, "cpu",
                           control_train.DP_RUNS)
    assert set(got) == set(control_train.DP_RUNS)
    for name, r in got.items():
        assert max(r["loss_gap"], r["grad_gap"], r["update_gap"]) > 1e-2, r
        assert not r["correct"], (name, r["checks"])
