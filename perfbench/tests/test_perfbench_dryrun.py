"""Each driver's whole run on the CPU at a tiny size (the look for a card
skipped, the model in float32): a sound run comes out correct, and a run
whose timed path is broken underneath comes out not correct, once for each
fault the cell can have (a step that leaves its state unchanged, half of
each batch left out with the mean over the rest, an answer altered where
it is produced). One-card cells need no exchange between cards."""

import pytest
import torch

from perfbench.tests.tiny import run, tiny_cell


def test_v33_sound_run_is_correct():
    out = run(tiny_cell("train_v33"))
    assert out.correct, out.checks
    assert out.metrics["train_tokens_per_s"] > 0 and out.attempted >= 1


def test_mlm_sound_run_is_correct():
    out = run(tiny_cell("train_mlm_512"))
    assert out.correct, out.checks
    assert out.metrics["train_tokens_per_s"] > 0


def test_search_sound_run_is_correct():
    out = run(tiny_cell("serve_postings_1m5"))
    assert out.correct, out.checks
    assert out.failed == 0 and out.attempted == 40
    assert 0 < out.metrics["search_p50_ms"] <= out.metrics["search_p95_ms"]


@pytest.mark.parametrize("cell", ["train_v33", "train_mlm_512"])
def test_a_step_that_leaves_its_state_unchanged_is_caught(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    out = run(tiny_cell(cell))
    assert not out.correct
    assert out.checks["update_gap"]["value"] == pytest.approx(1.0)


def test_v33_half_batch_is_caught(monkeypatch):
    from splade_tpu_torch.train import trainer

    inner = trainer.v33_loss

    def half(anchor, positive, negative, step, cfg, **kw):
        n = anchor.shape[0] // 2
        return inner(anchor[:n], positive[:n], negative[:n], step, cfg, **kw)

    monkeypatch.setattr(trainer, "v33_loss", half)
    out = run(tiny_cell("train_v33"))
    assert not out.correct, out.checks


def test_mlm_half_batch_is_caught(monkeypatch):
    from splade_tpu_torch.train import mlm

    make = mlm.make_mlm_loss_fn

    def halved(*a, **k):
        inner = make(*a, **k)

        def loss_fn(micro, rng, **kw):
            ids = micro["input_ids"]
            return inner({"input_ids": ids[:ids.shape[0] // 2]}, rng, **kw)

        loss_fn.mask = inner.mask
        return loss_fn

    monkeypatch.setattr(mlm, "make_mlm_loss_fn", halved)
    out = run(tiny_cell("train_mlm_512"))
    assert not out.correct, out.checks


def test_an_altered_answer_is_caught(monkeypatch):
    from splade_tpu_torch.serving.engine import ServingEngine

    inner = ServingEngine._search_batch_locked

    def altered(self, queries, k=10):
        out = inner(self, queries, k)
        return [[(f"d{(int(r[0][0][1:]) + 1) % len(self.index)}", r[0][1])]
                + r[1:] if r else r for r in out]

    monkeypatch.setattr(ServingEngine, "_search_batch_locked", altered)
    out = run(tiny_cell("serve_postings_1m5"))
    assert not out.correct, out.checks
