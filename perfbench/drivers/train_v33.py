"""A measured window of V33 training through the port's ``Trainer``.

Set-up writes the seed's triplets as JSONL under the run's temporary
directory, loads them with ``load_training_data``, builds one
``TripletCollator`` and one ``Trainer`` over a ``SpladeEncoder`` holding the
benchmark's weights, and drives that trainer through its first three
optimizer steps with ``Trainer.train_epoch``, the epoch loop ``train`` runs
(these steps warm every shape). The window is ``Trainer.train`` on the same
object for the run's seconds; it resumes the epoch after those steps.
``train_tokens_per_s``: the non-pad input tokens (queries, positives,
negatives) of the window's steps over the window. Then the reference
collates the three checked steps' rows from the raw triplets itself and
takes the same three steps in float32 (``reference/``).
"""

from __future__ import annotations

import json
import os

import torch

from perfbench.core import texts
from perfbench.core.bench import (Outcome, free_cache, log, now,
                                  peak_bytes, sync)
from perfbench.core.compare import checks, train_readings
from perfbench.core.train_window import StepProbe
from perfbench.core.weights import make_weights
from perfbench.drivers.common import (model_config, program_names,
                                      train_window)

CHECKED_STEPS = 3


def _recipe(cell, tmp: str) -> dict:
    recipe = json.loads(json.dumps(cell.config["train_v33"]))
    recipe["data"]["train_files"] = [os.path.join(tmp, "train_*.jsonl")]
    recipe["data"]["val_files"] = []
    recipe["training"]["output_dir"] = os.path.join(tmp, "run")
    return recipe


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        tmp: str, t_start: float) -> Outcome:
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.trainer import Trainer

    traffic = cell.traffic
    cfg_model = cell.config
    recipe = _recipe(cell, tmp)
    rows = traffic["triplets"]
    rowset = texts.triplets(seed, rows, tuple(traffic["query_words"]),
                            tuple(traffic["doc_words"]))
    with open(os.path.join(tmp, "train_000.jsonl"), "w",
              encoding="utf-8") as f:
        for row in rowset:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    data = load_training_data(recipe["data"]["train_files"])
    tok = texts.CharTokenizer(cfg_model["vocab_size"])
    cfg = V33Config.from_dict(recipe)
    weights = make_weights(cfg_model, seed, device)
    model = SpladeEncoder(model_config(cell, "train_v33"),
                          pool_impl="kernel", with_token_weights=False,
                          device=device)
    model.mlm.load_state_dict(weights)
    collator = TripletCollator(
        tok, query_max_length=cfg.data.query_max_length,
        doc_max_length=cfg.data.doc_max_length,
        num_hard_negatives=cfg.data.num_hard_negatives)
    trainer = Trainer(cfg, model, data, collator, device=device)
    params = program_names(trainer.model.named_parameters())
    masks = ("query_attention_mask", "positive_attention_mask",
             "negative_attention_mask")
    probe = StepProbe(
        trainer, params, weights,
        tokens=lambda b: sum(b[k].sum() for k in masks),
        capture=lambda b: {k: b[k].cpu() for k in
                           ("query_input_ids", "positive_input_ids")})
    probe.lengths_of = lambda b: {k: b[k].sum(-1) for k in masks}
    cfg.training.max_steps = CHECKED_STEPS
    trainer.train_epoch(1)
    sync()
    prog_losses = [float(x) for x in probe.losses]
    if trainer.state.step != CHECKED_STEPS:
        raise RuntimeError(f"set-up stopped at step {trainer.state.step}")
    setup_s = now() - t_start

    win, context, trace_out = train_window(
        probe, trace, tmp, seconds,
        lambda n: setattr(cfg.training, "max_steps", n))
    peak = peak_bytes()
    per_step = cfg.data.batch_size * cfg.training.gradient_accumulation_steps
    log(f"window: {win['steps']} steps, {win['tokens']:.0f} tokens in "
        f"{win['window_s']:.3f} s, "
        f"{win['steps'] * per_step / win['window_s']:.1f} triplets/s")
    context.update(model=cfg_model, kind="v33")
    captured = probe.batches
    grad1, change = probe.grad1_norms, probe.change_norms
    del trainer, model, probe, params, data, collator, weights
    free_cache()

    steps, unknown = rows_of(rowset, tok, captured,
                             recipe["data"]["query_max_length"])
    ref = reference_readings(cell, seed, rowset, tok, steps, device, recipe)
    readings = train_readings(prog_losses, ref["losses"], grad1,
                              ref["grad1"], change, ref["change"])
    readings.update(rows_unknown=unknown)
    log(f"losses program {prog_losses} reference {ref['losses']}; "
        f"worst gradient leaf {readings['_grad_leaf']}, worst change leaf "
        f"{readings['_update_leaf']}, {readings['_leaves']} of "
        f"{readings['_of']} leaves compared")
    return Outcome(
        metrics={"train_tokens_per_s": win["tokens"] / win["window_s"],
                 "setup_s": setup_s},
        attempted=win["steps"], failed=0,
        checks=checks(readings, traffic["limits"]),
        memory_peak_bytes=peak, context=context, trace=trace_out)


def rows_of(rowset, tok, captured, Sq: int) -> tuple:
    """(steps [[row indices of each micro-batch]], rows not found): the
    rows the program's checked steps carried, found by their query tokens
    and the first 32 tokens of their positive among the seed's triplets."""
    index = {(tuple(tok.codes(r["query"])[:Sq]),
              tuple(tok.codes(r["positive"])[:32])): i
             for i, r in enumerate(rowset)}
    unknown, steps = 0, []
    for batch in captured:
        q = batch["query_input_ids"].numpy()
        p = batch["positive_input_ids"].numpy()
        micro = []
        for a in range(q.shape[0]):
            found = []
            for b in range(q.shape[1]):
                key = (tuple(int(x) for x in q[a, b] if x),
                       tuple(int(x) for x in p[a, b, :32] if x))
                if key in index:
                    found.append(index[key])
                else:
                    unknown += 1
            micro.append(found)
        steps.append(micro)
    return steps, unknown


def reference_readings(cell, seed, rowset, tok, steps, device, recipe,
                       mm_name: str = "f32", keep_rows=None) -> dict:
    """The reference's optimizer steps over ``steps`` (row indices of each
    micro-batch), collated from the raw triplets here, from the seed's
    weights: each step's loss, the first gradient as the optimizer got it
    and the parameters' change after the last step, by leaf."""
    from perfbench.reference import precision
    from perfbench.reference.splade import v33_micro_grads
    from perfbench.reference.train import Reference, warmup_cosine

    precision.tf32_off()
    data, training = recipe["data"], recipe["training"]
    Sq, Sd = data["query_max_length"], data["doc_max_length"]

    def collate(idx):
        out = {}
        for name, S in (("query", Sq), ("positive", Sd), ("negative", Sd)):
            enc = tok([rowset[i][name] for i in idx], max_length=S)
            out[name + "_ids"] = torch.from_numpy(enc["input_ids"]).to(device)
            out[name + "_mask"] = torch.from_numpy(
                enc["attention_mask"]).to(device)
        return out

    batch = data["batch_size"]
    accum = training["gradient_accumulation_steps"]
    steps_per_epoch = max(len(rowset) // batch // accum, 1)
    lr = warmup_cosine(training["learning_rate"],
                       steps_per_epoch * training["num_epochs"],
                       training["warmup_ratio"])
    ref = Reference(make_weights(cell.config, seed, device), lr,
                    training["weight_decay"], training["gradient_clip"])
    initial = {n: ref.p[n].detach().clone() for n in ref.leaves}
    mm = precision.PRODUCTS[mm_name]
    losses, grad1 = [], {}
    for s, micro in enumerate(steps):
        total = 0.0
        for idx in micro:
            keep = keep_rows(len(idx)) if keep_rows is not None else ()
            total += v33_micro_grads(ref.p, cell.config, collate(idx), s,
                                     recipe["loss"], mm, keep)
        losses.append(total / len(micro))
        got = ref.apply(len(micro))
        if s == 0:
            grad1 = {n: float(g.double().norm()) for n, g in got.items()}
    change = {n: float((ref.p[n].detach() - initial[n]).double().norm())
              for n in ref.leaves}
    return {"losses": losses, "grad1": grad1, "change": change}
