"""A measured window of MLM pre-training through the port's ``MLMTrainer``.

Set-up makes the seed's Hangul lines, packs them with the port's
``pack_corpus`` into full rows, builds one ``MLMTrainer`` over a
``ModernBertForMaskedLM`` holding the benchmark's weights and drives it
through its first three optimizer steps with the epoch loop that
``MLMTrainer.train`` runs (``_train_epochs``, with a hang watchdog that is
off, as ``train`` arms it at the recipe's timeout of 0). The window is
``MLMTrainer.train`` on the same object; it resumes after those steps.
``train_tokens_per_s``: the non-pad tokens of the window's steps over the
window. ``MLMTrainer.train`` writes a checkpoint when it returns (about
1.8 GB with AdamW's state); the benchmark replaces that write with a call
that writes nothing, so the run writes little and the window holds steps
only.

The masking draws are the program's own state (a generator on the card
seeded from the run's seed, step and micro-batch): the reference cannot
draw them again. It takes the masked rows from the program's own masking
function, called after the window with the same generator seeds, checks
that stage by itself (every label is the row's token, nothing else
changed, the 80/10/10 split), and checks the rows against its own packing
of the raw lines; then it takes the three steps in float32.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
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


@contextlib.contextmanager
def no_checkpoint_writes(saved: list):
    from splade_tpu_torch.train import checkpoint

    orig = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda *a, **k: saved.append(k.get("epoch"))
    try:
        yield
    finally:
        checkpoint.save_checkpoint = orig


def pack(lines, tok, max_length: int) -> np.ndarray:
    """The reference's packing: each row [CLS] + max_length - 2 tokens of
    the lines' tokens back to back + [SEP]; the last row padded."""
    body = max_length - 2
    flat = [c for line in lines for c in tok.codes(line)]
    rows = []
    for i in range(0, len(flat), body):
        part = flat[i:i + body]
        row = [tok.cls_token_id] + part + [tok.sep_token_id]
        rows.append(row + [tok.pad_token_id] * (max_length - len(row)))
    return np.asarray(rows, np.int32)


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        tmp: str, t_start: float) -> Outcome:
    from splade_tpu_torch.models.modernbert import ModernBertForMaskedLM
    from splade_tpu_torch.train.mlm import MLMConfig, MLMTrainer, \
        mask_seed, pack_corpus
    from splade_tpu_torch.train.preemption import HangWatchdog

    traffic, cfg_model = cell.traffic, cell.config
    recipe = {k: v for k, v in cell.config["train_mlm"].items()
              if k != "model"}
    cfg = MLMConfig(**recipe, output_dir=os.path.join(tmp, "run"))
    tok = texts.CharTokenizer(cfg_model["vocab_size"])
    lines = texts.lines(seed, traffic["lines"], tuple(traffic["line_words"]))
    rows = pack_corpus(lines, tok, cfg.max_length)
    weights = make_weights(cfg_model, seed, device)
    model = ModernBertForMaskedLM(model_config(cell, "train_mlm")).to(device)
    model.load_state_dict(weights)
    saved: list = []
    with no_checkpoint_writes(saved):
        trainer = MLMTrainer(cfg, model, rows, tok, device=device)
        params = program_names(trainer.model.named_parameters())
        probe = StepProbe(
            trainer, params, weights,
            tokens=lambda b: (b["input_ids"] != tok.pad_token_id).sum(),
            capture=lambda b: {"input_ids": b["input_ids"].cpu()})
        probe.lengths_of = lambda b: {
            "rows": (b["input_ids"] != tok.pad_token_id).sum(-1)}
        cfg.max_steps = CHECKED_STEPS
        trainer._watchdog = HangWatchdog(0.0, name="mlm")
        trainer._train_epochs(lambda *a, **k: None)
        sync()
        prog_losses = [float(x) for x in probe.losses]
        if trainer.state.step != CHECKED_STEPS:
            raise RuntimeError(f"set-up stopped at step {trainer.state.step}")
        setup_s = now() - t_start
        win, context, trace_out = train_window(
            probe, trace, tmp, seconds,
            lambda n: setattr(cfg, "max_steps", n))
    peak = peak_bytes()
    log(f"window: {win['steps']} steps, {win['tokens']:.0f} tokens in "
        f"{win['window_s']:.3f} s; checkpoint writes replaced: {len(saved)}")
    context.update(model=cfg_model, kind="mlm",
                   masked=masked_positions(cfg))
    masked = []
    for s, batch in enumerate(probe.batches):
        ids = batch["input_ids"].to(device)
        micro = []
        for i in range(ids.shape[0]):
            gen = torch.Generator(device=ids.device).manual_seed(
                mask_seed(cfg.seed, s, i))
            corrupted, attn, pos, labels, w = trainer.loss_fn.mask(
                {"input_ids": ids[i]}, gen)
            micro.append({k: v.cpu() for k, v in dict(
                ids=ids[i], corrupted=corrupted, pos=pos, labels=labels,
                weights=w).items()})
        masked.append(micro)
    grad1, change = probe.grad1_norms, probe.change_norms
    del trainer, model, probe, params, weights, rows
    free_cache()

    ref = reference_readings(cell, seed, lines, tok, masked, device, cfg)
    readings = train_readings(prog_losses, ref["losses"], grad1,
                              ref["grad1"], change, ref["change"])
    readings.update({k: ref[k] for k in ("rows_unknown", "mask_faults",
                                         "split_z")})
    log(f"losses program {prog_losses} reference {ref['losses']}; "
        f"worst gradient leaf {readings['_grad_leaf']}, worst change leaf "
        f"{readings['_update_leaf']}, {readings['_leaves']} of "
        f"{readings['_of']} leaves compared; masking split {ref['split']}")
    return Outcome(
        metrics={"train_tokens_per_s": win["tokens"] / win["window_s"],
                 "setup_s": setup_s},
        attempted=win["steps"], failed=0,
        checks=checks(readings, traffic["limits"]),
        memory_peak_bytes=peak, context=context, trace=trace_out)


def masked_positions(cfg) -> int:
    return max(int(round(cfg.mlm_probability * (cfg.max_length - 2))), 1)


def check_masking(micro: dict, mask_id: int, P: int, specials) -> tuple:
    """(faults, [MASK], random, kept counts) of one masked micro-batch."""
    ids, cor = micro["ids"].long(), micro["corrupted"].long()
    pos, labels, w = micro["pos"].long(), micro["labels"].long(), \
        micro["weights"]
    faults = int((labels != ids.gather(1, pos)).sum())
    chosen = torch.zeros_like(ids, dtype=torch.bool).scatter(1, pos, True)
    faults += int((chosen.sum(1) != P).sum())           # repeated positions
    faults += int(((cor != ids) & ~chosen).sum())        # changed elsewhere
    eligible = (ids != 0) & ~torch.isin(ids, torch.as_tensor(specials))
    faults += int(((w > 0) & ~eligible.gather(1, pos)).sum())
    new = cor.gather(1, pos)
    live = w > 0
    n_mask = int(((new == mask_id) & live).sum())
    n_kept = int(((new == labels) & live).sum())
    n_rand = int(live.sum()) - n_mask - n_kept
    return faults, n_mask, n_rand, n_kept


def split_z(counts) -> float:
    """The largest distance of the [MASK] / random / kept shares from 80 /
    10 / 10%, in standard errors of a share over this many draws."""
    counts = np.asarray(counts, np.float64)
    n = max(counts.sum(), 1.0)
    want = np.array([0.8, 0.1, 0.1])
    return float((np.abs(counts / n - want)
                  / np.sqrt(want * (1 - want) / n)).max())


def reference_readings(cell, seed, lines, tok, masked, device, cfg,
                       mm_name: str = "f32", keep_rows=None) -> dict:
    from perfbench.reference import precision
    from perfbench.reference.mlm import mlm_micro_grads
    from perfbench.reference.train import Reference, warmup_cosine

    precision.tf32_off()
    rows = pack(lines, tok, cfg.max_length)
    known = {r.tobytes() for r in rows}
    unknown = faults = 0
    split = np.zeros(3)
    P = masked_positions(cfg)
    for step in masked:
        for micro in step:
            unknown += sum(r.astype(np.int32).tobytes() not in known
                           for r in micro["ids"].numpy())
            f, *counts = check_masking(micro, tok.mask_token_id, P,
                                       tok.all_special_ids)
            faults += f
            split += counts
    share = split / max(split.sum(), 1)
    n_val = max(int(len(rows) * cfg.val_fraction), 0)
    steps_per_epoch = (len(rows) - n_val) // (cfg.batch_size * cfg.grad_accum)
    lr = warmup_cosine(cfg.lr, steps_per_epoch * cfg.epochs, cfg.warmup_ratio)
    ref = Reference(make_weights(cell.config, seed, device), lr,
                    cfg.weight_decay, 1.0)
    initial = {n: ref.p[n].detach().clone() for n in ref.leaves}
    mm = precision.PRODUCTS[mm_name]
    losses, grad1 = [], {}
    for s, step in enumerate(masked):
        total = 0.0
        for micro in step:
            keep = (keep_rows(micro["ids"].shape[0]) if keep_rows is not None
                    else ())
            total += mlm_micro_grads(
                ref.p, cell.config,
                {k: v.to(device) for k, v in micro.items()},
                tok.pad_token_id, mm, keep)
        losses.append(total / len(step))
        got = ref.apply(len(step))
        if s == 0:
            grad1 = {n: float(g.double().norm()) for n, g in got.items()}
    change = {n: float((ref.p[n].detach() - initial[n]).double().norm())
              for n in ref.leaves}
    return {"losses": losses, "grad1": grad1, "change": change,
            "rows_unknown": unknown, "mask_faults": faults,
            "split": [round(float(x), 5) for x in share],
            "split_z": split_z(split)}
