"""A measured window of V33 training of a DeepSeek-V3 (MoE) backbone
through the port's ``Trainer``.

As ``train_v33.py``, with the configuration's DeepSeek-V3 decoder
(``models/deepseek_v3.py``) under ``SpladeEncoder``: the seed's triplets
as JSONL, ``load_training_data``, one ``TripletCollator``, one ``Trainer``
over the benchmark's weights (``core/moe_weights.py``), three set-up
optimizer steps through ``Trainer.train_epoch``, then ``Trainer.train`` on
the same object for the window. ``train_tokens_per_s``: the non-pad input
tokens of the window's steps over the window.

The comparison: the reference (``reference/deepseek_v3.py``) collates the
checked steps' rows from the raw triplets and takes the same three steps
in float32; the loss, first-gradient and update gaps by leaf, the rows it
could not find, ``route_gap``: the share of (valid token, choice)
pairs of the first step whose chosen expert is not among the reference's
choices for that token, over every MoE layer, and ``weight_gap``: over
the valid tokens of the first step for which both chose the same experts,
the norm of the gap between the program's and the reference's routing
weights over the norm of the reference's (the program's choices and
weights are those of each layer's first call, the forward; packed query
rows are mapped back to their queries).

The MoE layer's shapes change with every batch, which fragments the
caching allocator's fixed segments: the run sets expandable segments
before it allocates, as a deployment of this model sets
``PYTORCH_CUDA_ALLOC_CONF``.

Traced, the MoE layer's parts are attributed by the program's own profiler
ranges (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``)
and the grouped products' backward by their autograd node
(``GroupedMmBackward``), through names this driver adds to the trace's
scope table; the layers' counters (``deepseek_v3.moe_counters``, reset
when the window opens) give the held experts' rows a call for their
roofline and the held slots for the step's FLOPs.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping

import torch

from perfbench.core import texts, trace
from perfbench.core.bench import (Outcome, free_cache, log, now,
                                  peak_bytes, sync)
from perfbench.core.compare import checks, train_readings
from perfbench.core.moe_weights import frozen, make_weights
from perfbench.core.train_window import StepProbe
from perfbench.drivers.common import program_names, train_window
from perfbench.drivers.train_v33 import CHECKED_STEPS, _recipe, rows_of

#: trace scopes this driver adds: scope -> substring of the host range or
#: autograd node whose kernels it holds
MOE_SCOPES = {"moe_route": "moe.route", "moe_dispatch": "moe.dispatch",
              "moe_experts": "moe.experts", "moe_combine": "moe.combine",
              "moe_experts_bwd": "GroupedMmBackward",
              "mla_attention": "mla.attention"}


def model_config(cell):
    """The program's DeepseekV3Config: the file's published sizes, the
    router over every routed expert, this card's share of them."""
    from splade_tpu_torch.models.deepseek_v3 import DeepseekV3Config

    cfg = cell.config
    ep = cfg["expert_parallel"]
    m = cfg["train_v33"]["model"]
    return DeepseekV3Config.from_hf_dict(
        cfg, n_routed_experts=ep["router_experts"], expert_shares=ep["shares"],
        expert_share=ep["share"], remat=m["remat"],
        attention_impl=m["attention_impl"])


class OnDevice(Mapping):
    """Host tensors handed to the card one at a time (the initial weights
    the change is measured from, kept off the card's memory)."""

    def __init__(self, host: dict, device):
        self.host, self.device = host, device

    def __getitem__(self, name):
        return self.host[name].to(self.device)

    def __iter__(self):
        return iter(self.host)

    def __len__(self):
        return len(self.host)


class RouteCapture:
    """Each MoE layer's chosen experts and their weights at its first call
    (the first step's forward), on the host, while entered."""

    def __init__(self):
        self.routes = {}

    def __enter__(self):
        from splade_tpu_torch.models.deepseek_v3 import DeepseekV3MoE

        self.cls, self.orig = DeepseekV3MoE, DeepseekV3MoE.route
        routes, orig = self.routes, self.orig

        def route(moe, x):
            idx, w = orig(moe, x)
            if id(moe) not in routes:
                routes[id(moe)] = (idx.cpu(), w.detach().float().cpu())
            return idx, w

        DeepseekV3MoE.route = route
        return self

    def __exit__(self, *exc):
        self.cls.route = self.orig

    def by_layer(self, model) -> list:
        from splade_tpu_torch.models.deepseek_v3 import moe_layers

        return [self.routes[id(m)] for m in moe_layers(model)
                if id(m) in self.routes]


def run(cell, seed: int, seconds: float, trace_on: bool, device: str,
        tmp: str, t_start: float) -> Outcome:
    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.deepseek_v3 import (moe_counters,
                                                     reset_moe_counters)
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.trainer import Trainer

    if device == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    traffic = cell.traffic
    cfg_model = cell.config
    recipe = _recipe(cell, tmp)
    rowset = texts.triplets(seed, traffic["triplets"],
                            tuple(traffic["query_words"]),
                            tuple(traffic["doc_words"]))
    with open(os.path.join(tmp, "train_000.jsonl"), "w",
              encoding="utf-8") as f:
        for row in rowset:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    data = load_training_data(recipe["data"]["train_files"])
    tok = texts.CharTokenizer(cfg_model["vocab_size"])
    cfg = V33Config.from_dict(recipe)
    model = SpladeEncoder(model_config(cell), pool_impl="kernel",
                          with_token_weights=False, device=device)
    weights = make_weights(cfg_model, seed, device)
    model.mlm.load_state_dict(weights)
    initial = OnDevice({n: w.cpu() for n, w in weights.items()
                        if not frozen(n)}, device)
    del weights
    free_cache()
    collator = TripletCollator(
        tok, query_max_length=cfg.data.query_max_length,
        doc_max_length=cfg.data.doc_max_length,
        num_hard_negatives=cfg.data.num_hard_negatives)
    trainer = Trainer(cfg, model, data, collator, device=device)
    params = program_names(trainer.model.named_parameters())
    masks = ("query_attention_mask", "positive_attention_mask",
             "negative_attention_mask")
    probe = StepProbe(
        trainer, params, initial,
        tokens=lambda b: sum(b[k].sum() for k in masks),
        capture=lambda b: {k: b[k].cpu() for k in
                           ("query_input_ids", "positive_input_ids",
                            *masks)})
    probe.lengths_of = lambda b: {k: b[k].sum(-1) for k in masks}
    cfg.training.max_steps = CHECKED_STEPS
    with RouteCapture() as capture:
        trainer.train_epoch(1)
    sync()
    prog_routes = capture.by_layer(model)
    prog_losses = [float(x) for x in probe.losses]
    if trainer.state.step != CHECKED_STEPS:
        raise RuntimeError(f"set-up stopped at step {trainer.state.step}")
    setup_s = now() - t_start
    log(f"set-up {setup_s:.1f} s; peak {peak_bytes() / 1e9:.2f} GB")

    reset_moe_counters(model)
    for name, node in MOE_SCOPES.items():
        trace.BACKWARD_NODES.setdefault(name, node)
    win, context, trace_out = train_window(
        probe, trace_on, tmp, seconds,
        lambda n: setattr(cfg.training, "max_steps", n))
    peak = peak_bytes()
    counters = moe_counters(model)
    per_step = cfg.data.batch_size * cfg.training.gradient_accumulation_steps
    log(f"window: {win['steps']} steps, {win['tokens']:.0f} tokens in "
        f"{win['window_s']:.3f} s, "
        f"{win['steps'] * per_step / win['window_s']:.1f} triplets/s; "
        f"peak {peak / 1e9:.2f} GB; MoE layer 1 counters {counters[0]}")
    if trace_out is not None:
        log("trace scopes (s, calls): " + json.dumps(
            {k: [trace_out.scope_s.get(k), trace_out.scope_n.get(k)]
             for k in list(MOE_SCOPES) + ["pool_fwd", "pool_bwd"]}))
        grouped = sum(t for n, t in trace_out.kernels if "group" in n.lower())
        log(f"grouped-product kernels {grouped:.4f} s; in the experts' "
            f"scopes {trace_out.scope_s.get('moe_experts', 0.0) + trace_out.scope_s.get('moe_experts_bwd', 0.0):.4f} s")
        log("top kernels: " + json.dumps(trace_out.kernels[:12]))
    context.update(model=cfg_model, kind="v33", moe=counters)
    captured = probe.batches
    grad1, change = probe.grad1_norms, probe.change_norms
    del trainer, model, probe, params, data, collator, initial
    free_cache()

    steps, unknown = rows_of(rowset, tok, captured,
                             recipe["data"]["query_max_length"])
    t_ref = now()
    ref = reference_readings(cell, seed, rowset, tok, steps, device, recipe)
    log(f"reference: {now() - t_ref:.1f} s")
    readings = train_readings(prog_losses, ref["losses"], grad1,
                              ref["grad1"], change, ref["change"])
    readings.update(rows_unknown=unknown,
                    **route_readings(prog_routes, ref["routes"], captured[0],
                                     cfg_model))
    log(f"losses program {prog_losses} reference {ref['losses']}; "
        f"worst gradient leaf {readings['_grad_leaf']}, worst change leaf "
        f"{readings['_update_leaf']}, {readings['_leaves']} of "
        f"{readings['_of']} leaves compared; median leaf gaps "
        f"{readings['grad_gap_median']} / {readings['update_gap_median']}; "
        f"route gap {readings['route_gap']}, weight gap "
        f"{readings['weight_gap']}")
    return Outcome(
        metrics={"train_tokens_per_s": win["tokens"] / win["window_s"],
                 "setup_s": setup_s},
        attempted=win["steps"], failed=0,
        checks=checks(readings, traffic["limits"]),
        memory_peak_bytes=peak, context=context, trace=trace_out)


def route_sums(parts) -> dict:
    """``route_gap`` and ``weight_gap`` over ``parts``: (got, want, mask),
    got and want each (chosen experts, their weights), [..., k] over the
    same tokens, mask the valid ones. ``route_gap``: the share of valid
    (token, choice) pairs of ``got`` whose expert ``want`` did not choose
    for that token; ``weight_gap``: over the valid tokens where both chose
    the same k experts, the norm of got's weights less want's weights of
    the same experts, over the norm of want's (1 where no token agrees)."""
    differ = total = 0
    gap2 = ref2 = 0.0
    for (gi, gw), (wi, ww), mask in parts:
        same = gi[..., :, None] == wi[..., None, :]
        hit = same.any(-1)
        differ += int((~hit).sum(-1)[mask].sum())
        total += int(mask.sum()) * gi.shape[-1]
        agree = hit.all(-1) & mask
        want = (same * ww[..., None, :].double()).sum(-1)[agree]
        gap2 += float((gw.double()[agree] - want).pow(2).sum())
        ref2 += float(want.pow(2).sum())
    return {"route_gap": differ / max(total, 1),
            "weight_gap": (gap2 / ref2) ** 0.5 if ref2 else 1.0}


def route_readings(prog_routes, ref_routes, batch, cfg) -> dict:
    """``route_sums`` of the program's first step against the reference.
    prog_routes: per MoE layer ([R * S, k] experts, [R * S, k] weights)
    over the packed rows (documents: positives then negatives; then the
    query rows, ``pack`` queries a row); ref_routes: name -> layer ->
    blocks of ([rows, S, k], [rows, S, k])."""
    if not prog_routes:
        return {"route_gap": 1.0, "weight_gap": 1.0}
    q_mask = batch["query_attention_mask"][0].bool()
    p_mask = batch["positive_attention_mask"][0].bool()
    n_mask = batch["negative_attention_mask"][0].bool()
    B, Sq = q_mask.shape
    Sd = p_mask.shape[1]
    k = cfg["num_experts_per_tok"]
    layers = sorted(ref_routes["query"])
    parts = []
    for li, prog in zip(layers, prog_routes):
        idx, w = (t.view(-1, Sd, k) for t in prog)
        ref = {n: tuple(torch.cat(t) for t in zip(*ref_routes[n][li]))
               for n in ref_routes}
        parts += [((idx[:B], w[:B]), ref["positive"], p_mask),
                  ((idx[B:2 * B], w[B:2 * B]), ref["negative"], n_mask),
                  (tuple(t[2 * B:].reshape(-1, Sq, k)[:B] for t in (idx, w)),
                   ref["query"], q_mask)]
    return route_sums(parts)


def collate_rows(rowset, tok, idx, data, device) -> dict:
    """The reference's micro-batch of rows ``idx``: each tower's ids and
    mask, unpacked."""
    out = {}
    for name, S in (("query", data["query_max_length"]),
                    ("positive", data["doc_max_length"]),
                    ("negative", data["doc_max_length"])):
        enc = tok([rowset[i][name] for i in idx], max_length=S)
        out[name + "_ids"] = torch.from_numpy(enc["input_ids"]).to(device)
        out[name + "_mask"] = torch.from_numpy(
            enc["attention_mask"]).to(device)
    return out


def reference_readings(cell, seed, rowset, tok, steps, device, recipe,
                       mm_name: str = "f32", keep_rows=None, fault=None
                       ) -> dict:
    """The reference's optimizer steps over ``steps`` (row indices of each
    micro-batch) from the seed's weights: each step's loss, the first
    gradient as the optimizer got it, the parameters' change after the
    last step by leaf, and the first micro-batch's chosen experts and
    their weights."""
    from perfbench.reference import precision
    from perfbench.reference.deepseek_v3 import (UntiedReference,
                                                 v33_micro_grads)
    from perfbench.reference.train import warmup_cosine

    precision.tf32_off()
    data, training = recipe["data"], recipe["training"]
    batch = data["batch_size"]
    accum = training["gradient_accumulation_steps"]
    steps_per_epoch = max(len(rowset) // batch // accum, 1)
    lr = warmup_cosine(training["learning_rate"],
                       steps_per_epoch * training["num_epochs"],
                       training["warmup_ratio"])
    ref = UntiedReference(make_weights(cell.config, seed, device), lr,
                          training["weight_decay"], training["gradient_clip"],
                          frozen)
    mm = precision.PRODUCTS[mm_name]
    losses, grad1, routes = [], {}, {}
    for s, micro in enumerate(steps):
        total = 0.0
        for m, idx in enumerate(micro):
            keep = keep_rows(len(idx)) if keep_rows is not None else ()
            total += v33_micro_grads(ref.p, cell.config,
                                     collate_rows(rowset, tok, idx, data,
                                                  device),
                                     s, recipe["loss"], mm, keep, fault,
                                     routes if s == m == 0 else None)
        losses.append(total / len(micro))
        got = ref.apply(len(micro))
        if s == 0:
            grad1 = {n: float(g.double().norm()) for n, g in got.items()}
    return {"losses": losses, "grad1": grad1, "change": ref.change_norms(),
            "routes": routes}


def reference_routes(cell, seed, rowset, tok, idx, device, recipe,
                     mm_name: str = "f32", fault=None) -> dict:
    """The chosen experts and their weights of ``reference_readings``'
    first micro-batch (rows ``idx``) alone: its graph-free pass, no
    gradient."""
    from perfbench.reference import precision
    from perfbench.reference.deepseek_v3 import encode_rows

    precision.tf32_off()
    p = {n: w.float() for n, w in
         make_weights(cell.config, seed, device).items()}
    micro = collate_rows(rowset, tok, idx, recipe["data"], device)
    mm = precision.PRODUCTS[mm_name]
    routes = {}
    with torch.no_grad():
        for name in ("query", "positive", "negative"):
            encode_rows(p, cell.config, micro[name + "_ids"],
                        micro[name + "_mask"], mm, fault,
                        routes.setdefault(name, {}))
    return routes
