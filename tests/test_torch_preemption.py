"""The port's preemption hook and hang watchdog
(splade_tpu_torch.train.preemption) and their wiring into ``Trainer``.

The four cases of tests/test_watchdog.py, on the port's classes (the same
behaviour is asserted of splade_tpu's class beside them), then the
preemption path: a SIGTERM during a step sets the flag, the loop stops at
that step's boundary, writes a checkpoint and returns; a fresh Trainer
resumed from it ends bitwise equal to a run that was never interrupted."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from splade_tpu.train.preemption import HangWatchdog as JaxWatchdog
from splade_tpu_torch.config import V33Config
from splade_tpu_torch.data.collator import TripletCollator
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.train import checkpoint as ckpt
from splade_tpu_torch.train.preemption import (HangWatchdog, heartbeat_if_due,
                                               install_preemption_handler)
from splade_tpu_torch.train.trainer import Trainer

from test_data import FakeTokenizer

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

BOTH = pytest.mark.parametrize("cls", [HangWatchdog, JaxWatchdog],
                               ids=["port", "jax"])


@BOTH
def test_watchdog_trips_without_beats(cls):
    tripped = threading.Event()
    wd = cls(0.2, on_trip=tripped.set)
    try:
        assert tripped.wait(3.0), "watchdog never tripped"
    finally:
        wd.stop()


@BOTH
def test_watchdog_stays_quiet_while_beating(cls):
    tripped = threading.Event()
    wd = cls(1.5, on_trip=tripped.set)  # wide: the test host may be busy
    try:
        for _ in range(8):
            time.sleep(0.1)
            wd.beat()
        assert not tripped.is_set()
    finally:
        wd.stop()
    time.sleep(1.8)  # after stop() no trip fires even once beats cease
    assert not tripped.is_set()


@BOTH
def test_watchdog_disabled_at_zero(cls):
    tripped = threading.Event()
    wd = cls(0.0, on_trip=tripped.set)
    time.sleep(0.3)
    assert not tripped.is_set()
    assert not wd._thread.is_alive()
    assert not wd.beat_due()
    wd.stop()
    assert cls.EXIT_CODE == 17


def test_heartbeat_if_due_forces_one_sync_per_half_window():
    class Metric:
        reads = 0

        def __float__(self):
            Metric.reads += 1
            return 1.0

    wd = HangWatchdog(2.0, on_trip=lambda: None)
    try:
        heartbeat_if_due(wd, Metric())       # just beaten: no sync
        assert Metric.reads == 0 and not wd.beat_due()
        time.sleep(1.1)                      # past half the window
        assert wd.beat_due()
        heartbeat_if_due(wd, Metric())
        assert Metric.reads == 1 and not wd.beat_due()
    finally:
        wd.stop()
    heartbeat_if_due(None, Metric())         # no watchdog: nothing read
    assert Metric.reads == 1


def _samples(n=64, seed=7):
    rng = np.random.default_rng(seed)
    words = ["검색", "모델", "한국어", "문서", "질의", "벡터"]
    mk = lambda: " ".join(rng.choice(words, size=4))
    return [{"query": mk(), "positive": mk(), "negative": mk()}
            for _ in range(n)]


def _trainer(out, **training):
    t = {"num_epochs": 2, "gradient_accumulation_steps": 2,
         "log_every_n_steps": 1, "save_every_n_epochs": 2,
         "eval_every_n_epochs": 100, "learning_rate": 1e-3,
         "output_dir": str(out)}
    t.update(training)
    cfg = V33Config.from_dict({
        "model": {"dtype": "float32"}, "mesh": {"num_data": 1},
        "data": {"batch_size": 8, "query_max_length": 8,
                 "doc_max_length": 16},
        "training": t})
    model = SpladeEncoder(ModernBertConfig.tiny(num_hidden_layers=2),
                          pool_impl="kernel", with_token_weights=False,
                          device="cpu").init_weights(0)
    col = TripletCollator(FakeTokenizer(), query_max_length=8,
                          doc_max_length=16)
    return Trainer(cfg, model, _samples(), col, device="cpu")


def test_trainer_wires_watchdog_and_completes(tmp_path):
    """A tiny real Trainer run with the watchdog armed: beats keep it
    quiet, training completes, and the watchdog thread is stopped. A long
    logging interval leaves the beats to heartbeat_if_due."""
    trainer = _trainer(tmp_path, num_epochs=1, watchdog_timeout_s=120.0,
                       log_every_n_steps=1000)
    state = trainer.train()
    assert state.step == trainer.total_steps == 4
    assert trainer._watchdog.timeout_s == 120.0
    assert not trainer._watchdog._thread.is_alive()  # stopped in finally
    # step 1 logs (a resolved loss) and the final checkpoint write beats
    assert trainer._watchdog.beats >= 2 and not trainer._watchdog.tripped


def test_watchdog_is_stopped_when_training_raises(tmp_path):
    trainer = _trainer(tmp_path, num_epochs=1, watchdog_timeout_s=60.0)

    def boom(state, batch):
        raise FloatingPointError("non-finite loss")

    trainer.step_fn = boom
    with pytest.raises(FloatingPointError):
        trainer.train()
    trainer._watchdog._thread.join(timeout=5.0)
    assert not trainer._watchdog._thread.is_alive()


def test_sigterm_checkpoints_at_the_step_boundary_and_resume_is_exact(
        tmp_path):
    """4 steps an epoch, 2 epochs. SIGTERM arrives inside step 3: the run
    stops with step 3 complete, checkpoints and returns; the resumed run's
    parameters equal the uninterrupted run's bitwise."""
    full = _trainer(tmp_path / "a")
    assert full.steps_per_epoch == 4 and full.total_steps == 8
    full.cfg.training.max_steps = 6
    full_state = full.train()

    cut = _trainer(tmp_path / "b")
    cut.cfg.training.max_steps = 6
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    replaced = cut.install_preemption_handler()
    assert replaced == before
    real_step = cut.step_fn

    def step_then_signal(state, batch):
        if state.step == 2:  # the third step: the signal lands inside it
            os.kill(os.getpid(), signal.SIGTERM)
        return real_step(state, batch)

    cut.step_fn = step_then_signal
    try:
        state = cut.train()
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
    assert cut._preempted and state.step == 3
    path = ckpt.find_latest_checkpoint(str(tmp_path / "b"))
    assert path is not None and path.endswith("checkpoint_epoch1_step3")
    assert {s: signal.getsignal(s) for s in before} == before

    res = _trainer(tmp_path / "c")
    res.state, meta = ckpt.load_checkpoint(path, res.state)
    assert meta["full_resume"] and res.state.step == 3
    res.start_epoch = min(res.state.step // res.steps_per_epoch + 1, 2)
    res.cfg.training.max_steps = 6
    assert res.train().step == 6 and not res._preempted
    for a, b in zip(full_state.model.parameters(), res.model.parameters()):
        assert torch.equal(a, b)


def test_handler_only_sets_the_flag():
    class Box:
        _preempted = False

    box = Box()
    replaced = install_preemption_handler(box)
    try:
        os.kill(os.getpid(), signal.SIGINT)
        time.sleep(0.05)
        assert box._preempted
    finally:
        for sig, handler in replaced.items():
            signal.signal(sig, handler)
