"""Pieces the drivers share: the program's model configuration from a
configuration file, the program's parameters by the reference's names, the
profiler scopes around calls into the program, and a traced stretch of
training steps."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from perfbench.core.trace import Tracer, scope
from perfbench.core.train_window import loop_gaps_ms

#: configuration keys the program's ModernBertConfig takes
MODEL_KEYS = ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "global_attn_every_n_layers", "local_attention",
              "global_rope_theta", "local_rope_theta", "norm_eps",
              "pad_token_id", "max_position_embeddings", "decoder_bias")


def model_config(cell, route: str):
    """The program's ModernBertConfig for one route of the configuration
    (``train_v33``, ``serve`` or ``train_mlm``): the published sizes and
    the route's ``model`` settings (remat, attention_impl)."""
    from splade_tpu_torch.models.modernbert import ModernBertConfig

    kw = {k: cell.config[k] for k in MODEL_KEYS if k in cell.config}
    m = cell.config[route].get("model", {})
    kw.update({k: m[k] for k in ("remat", "attention_impl") if k in m})
    return ModernBertConfig(**kw)


def program_names(named) -> Dict[str, torch.nn.Parameter]:
    """The program's parameters under HuggingFace names (without the
    SPLADE wrapper's ``mlm.`` prefix); the tied embedding once."""
    out = {}
    for name, p in named:
        out[name[4:] if name.startswith("mlm.") else name] = p
    return out


class ScopedCalls:
    """While tracing, the calls into the program's operations whose
    rooflines are read run inside profiler scopes, and each call's shapes
    (and data-dependent counts, kept on the card) are recorded while the
    tracer runs. Untraced runs leave the program as it is."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.records: Dict[str, List[dict]] = {"pool_fwd": [],
                                               "splash_fwd": [],
                                               "rescore": []}
        self._undo: List[tuple] = []

    def _patch(self, module, attr, make):
        orig = getattr(module, attr)
        setattr(module, attr, make(orig))
        self._undo.append((module, attr, orig))

    def __enter__(self):
        if not self.enabled:
            return self
        from splade_tpu_torch.models import modernbert, splade
        from splade_tpu_torch.ops import postings_index

        def pool(orig):
            def wrapped(h, w, bias, mask):
                with scope("pool_fwd"):
                    out = orig(h, w, bias, mask)
                if self.active:
                    self.records["pool_fwd"].append(dict(
                        B=h.shape[0], S=h.shape[1], H=h.shape[2],
                        V=w.shape[0], valid=mask.sum(),
                        matches=(out[0] > 0).sum(),
                        grad=torch.is_grad_enabled()))
                return out
            return wrapped

        def splash(orig):
            def wrapped(q, k, v, seg, half_window):
                with scope("splash_fwd"):
                    out = orig(q, k, v, seg, half_window)
                if self.active:
                    B, N, S, D = q.shape
                    self.records["splash_fwd"].append(dict(
                        B=B, N=N, S=S, D=D, grad=torch.is_grad_enabled()))
                return out
            return wrapped

        def rescore(orig):
            def wrapped(d_terms, d_vals, d_scale, q_idx, q_val, cand):
                with scope("rescore"):
                    out = orig(d_terms, d_vals, d_scale, q_idx, q_val, cand)
                if self.active:
                    B, C = cand.shape
                    self.records["rescore"].append(dict(
                        B=B, C=C, M=d_vals.shape[1], T=q_idx.shape[1],
                        rows=torch.unique(cand).numel()))
                return out
            return wrapped

        self._patch(splade, "fused_splade_pool", pool)
        self._patch(modernbert, "splash_attention", splash)
        self._patch(postings_index, "rescore_match", rescore)
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()


class TracedSteps:
    """Traces window steps ``first + 1`` to ``first + count`` of a
    ``StepProbe``: the tracer starts once step ``first`` has been issued
    and stops once step ``first + count`` has."""

    def __init__(self, probe, calls: ScopedCalls, tmp: str, first: int,
                 count: int):
        self.tracer = Tracer(tmp)
        self.calls = calls
        self.first, self.count = first, count
        self.steps = 0
        self.overhead_s = 0.0  # the window's time spent starting, stopping
        self.after = set()     # window steps followed by that work
        probe.on_step = self.on_step

    def on_step(self, n: int) -> None:
        t0 = time.perf_counter()
        if n == self.first:
            self.tracer.start()
            self.calls.active = True
            self.after.add(n)
        elif n == self.first + self.count and self.tracer.running:
            self.finish(n - self.first)
            self.after.add(n)
        self.overhead_s += time.perf_counter() - t0

    def finish(self, steps: int) -> None:
        self.calls.active = False
        self.tracer.stop()
        self.steps = steps

    @property
    def result(self):
        return self.tracer.read()

    def close(self, window_steps: int) -> None:
        """A window too short for the traced stretch ends it at its end."""
        if self.tracer.running:
            self.finish(window_steps - self.first)


def train_window(probe, trace: bool, tmp: str, seconds: float,
                 set_max_steps) -> tuple:
    """The window of a trainer (``StepProbe.run_window``), traced over two
    steps after two when ``trace``: (window dict, context for the readers,
    Trace or None)."""
    calls = ScopedCalls(trace)
    traced = TracedSteps(probe, calls, tmp, first=2, count=2) if trace \
        else None
    if traced is not None:
        traced.tracer.warm()
    with calls:
        win = probe.run_window(seconds, set_max_steps)
        if traced is not None:
            traced.close(win["steps"])
    context = {
        "window": win, "records": calls.records,
        "loop_gaps_ms": loop_gaps_ms(probe.spans,
                                     traced.after if traced else ()),
        "lengths": [{k: v.cpu().numpy() for k, v in b.items()}
                    for b in probe.window_batches],
        "tracer_s": traced.overhead_s if traced else 0.0,
        "steps_traced": traced.steps if traced else 0}
    return win, context, (traced.result if traced else None)
