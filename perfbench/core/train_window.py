"""The measured window of a trainer, and what the comparison needs from
its first steps.

``StepProbe`` replaces the trainer instance's ``step_fn`` with a wrapper
around it. Set-up drives the same trainer object through its first
``checked`` steps with the trainer's own ``train()``; the wrapper keeps
those steps' batches (host copies), their losses, the per-leaf norm of the
first gradient as AdamW's first moment holds it after step 1, and the
per-leaf norm of the parameters' change after the last checked step, before
the next step changes them. The window is a second ``train()`` on the same
object: after each step's call returns, the wrapper ends the run once the
window's time is up (it lowers ``max_steps`` to the step count, so the
trainer's own loop stops before another step). Every step of the window is
whole; the window closes when the last one has finished on the card.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, List, Optional

import torch

from perfbench.core.bench import now, sync


class StepProbe:
    def __init__(self, trainer, params: Dict[str, torch.Tensor],
                 initial: Dict[str, torch.Tensor],
                 tokens: Callable[[dict], torch.Tensor],
                 capture: Callable[[dict], dict], checked: int = 3):
        """params: the trainer's leaves by reference name; initial: their
        values before step 1; tokens(batch) -> the step's non-pad input
        tokens as a device scalar; capture(batch) -> a host copy of what
        the reference needs."""
        self.trainer = trainer
        self.inner = trainer.step_fn
        self.params, self.initial = params, initial
        self.tokens_of, self.capture_of = tokens, capture
        self.checked = checked
        self.batches: List[dict] = []
        self.losses: List[torch.Tensor] = []
        self.grad1_norms: Dict[str, float] = {}
        self.change_norms: Dict[str, float] = {}
        self.deadline: Optional[float] = None
        self.window_tokens: List[torch.Tensor] = []
        self.window_batches: List[dict] = []
        self.spans: List[tuple] = []          # (call, return) host times
        self.on_step: Optional[Callable[[int], None]] = None
        self.lengths_of: Callable[[dict], dict] = lambda batch: {}
        trainer.step_fn = self

    def __getattr__(self, name):  # the step's own attributes (reducer)
        return getattr(self.inner, name)

    def __call__(self, state, batch):
        t_call = now()
        metrics = self.inner(state, batch)
        t_ret = now()
        step = state.step
        if self.deadline is None:           # set-up: the checked steps
            self.batches.append(self.capture_of(batch))
            self.losses.append(metrics["loss"].detach().clone())
            if step == 1:
                opt = self.trainer.state.optimizer
                self.grad1_norms = {
                    n: float(opt.state[p]["exp_avg"].double().norm())
                    / (1 - opt.param_groups[0]["betas"][0])
                    for n, p in self.params.items() if p in opt.state}
            if step == self.checked:
                with torch.no_grad():
                    self.change_norms = {
                        n: float((p.detach() - self.initial[n]).double()
                                 .norm())
                        for n, p in self.params.items()}
            return metrics
        self.spans.append((t_call, t_ret))
        self.window_tokens.append(self.tokens_of(batch))
        self.window_batches.append(self.lengths_of(batch))
        self.window_steps_done = len(self.spans)
        if self.on_step is not None:
            self.on_step(len(self.spans))
        if now() >= self.deadline:
            self.stop_after(step)
        return metrics

    def stop_after(self, step: int) -> None:
        cfg = self.trainer.cfg
        training = getattr(cfg, "training", cfg)
        training.max_steps = step

    def run_window(self, seconds: float, max_steps_attr) -> dict:
        """One train() on the same trainer for ``seconds``; returns the
        window's length, steps and tokens."""
        max_steps_attr(10 ** 9)
        gc.collect()  # as the search window does: steadier windows
        sync()
        t0 = now()
        self.deadline = t0 + seconds
        self.trainer.train()
        sync()
        t1 = now()
        tokens = float(torch.stack(self.window_tokens).sum()) \
            if self.window_tokens else 0.0
        return {"window_s": t1 - t0, "steps": len(self.spans),
                "tokens": tokens, "t0": t0, "t1": t1}


def loop_gaps_ms(spans: List[tuple], skip=()) -> List[float]:
    """Host ms from one step_fn return to the next call, leaving out the
    gaps after the window steps in ``skip`` (1-based), where the benchmark
    itself worked (starting or stopping the tracer)."""
    return [(b[0] - a[1]) * 1e3 for i, (a, b) in enumerate(
        zip(spans, spans[1:]), start=1) if i not in skip]

