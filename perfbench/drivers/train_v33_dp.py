"""A measured window of data-parallel V33 training: the ``train_v33``
recipe on each of the cell's ranks, one process a card.

The run's own process is rank 0; it starts ranks 1 to W-1 as processes of
this file (``python perfbench/drivers/train_v33_dp.py worker SPEC RANK``)
and they join one process group through ``parallel/mesh.py``'s
``init_distributed`` (NCCL on ``cuda:{rank}``, gloo on the CPU, at
``tcp://localhost:<a free port>``). Each rank loads its slice of the
seed's triplets through the ``Trainer``'s loader (``data.batch_size`` rows
of every micro-batch, 4 micro-batches a step) and takes one gradient
all-reduce a step (``GradReducer``). Rank 0 decides when the window has
run its time and the ranks agree on it every step (on the host group), so
all stop after the same step.

``train_tokens_per_s``: the non-pad input tokens of every rank's window
steps over rank 0's window. ``train.allreduce_ms``: rank 0's
``GradReducer.last_ms`` after each window step of a traced run. The
comparison: each rank's reference takes the three checked steps on the
rows its program carried (found by their tokens), the ranks' reference
gradients are summed and divided by the world size before each
optimizer step, as DDP averages them, and rank 0 holds the program's
numbers against it (``core/compare.py``, the limits of the traffic file).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":  # a rank's process: the repository on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from perfbench.core import bench, texts  # noqa: E402
from perfbench.core.bench import (Outcome, free_cache, log, now,  # noqa
                                  peak_bytes, sync)
from perfbench.core.compare import checks, train_readings  # noqa: E402
from perfbench.core.train_window import StepProbe  # noqa: E402
from perfbench.core.weights import make_weights  # noqa: E402
from perfbench.drivers.common import (model_config, program_names,  # noqa
                                      train_window)
from perfbench.drivers.train_v33 import CHECKED_STEPS, _recipe, rows_of  # noqa

#: seconds a rank's process may take beyond rank 0's end
JOIN_TIMEOUT_S = 600


class AgreedProbe(StepProbe):
    """``StepProbe`` whose window ends on every rank after the same step:
    rank 0 says when its time is up, the ranks agree after each step."""

    def __init__(self, *args, mesh, **kw):
        self.mesh = mesh
        self._hook = None
        self.after_step = None
        super().__init__(*args, **kw)

    @property
    def on_step(self):
        return self._agreed

    @on_step.setter
    def on_step(self, fn):
        self._hook = fn

    def _agreed(self, n: int) -> None:
        from splade_tpu_torch.parallel.mesh import agree_any

        for fn in (self._hook, self.after_step):
            if fn is not None:
                fn(n)
        if agree_any(self.mesh.is_main and now() >= self.deadline,
                     self.mesh):
            StepProbe.stop_after(self, self.trainer.state.step)

    def stop_after(self, step: int) -> None:
        """The rank's own clock decides nothing (``_agreed`` does)."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        tmp: str, t_start: float) -> Outcome:
    world = cell.traffic["ranks"]
    spec = {"name": cell.name, "chips": cell.chips, "config": cell.config,
            "config_name": cell.config_name, "traffic": cell.traffic,
            "traffic_name": cell.traffic_name, "seed": seed,
            "seconds": seconds, "device": device, "tmp": tmp,
            "port": _free_port()}
    path = os.path.join(tmp, "ranks.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # the ranks' output goes to standard error: the last line of standard
    # output is rank 0's result
    procs = [subprocess.Popen([sys.executable, __file__, "worker", path,
                               str(r)], stdout=2, env=env)
             for r in range(1, world)]
    try:
        out = rank_run(cell, seed, seconds, trace, device, tmp, t_start, 0,
                       world, spec["port"])
        for p in procs:
            if p.wait(timeout=JOIN_TIMEOUT_S):
                raise RuntimeError(f"a rank exited with {p.returncode}")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def rank_run(cell, seed, seconds, trace, device, tmp, t_start, rank, world,
             port) -> Outcome:
    import torch.distributed as dist

    from splade_tpu_torch.config import V33Config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.parallel.mesh import init_distributed
    from splade_tpu_torch.train.trainer import Trainer

    # one intra-op thread a rank, as torchrun sets it for several
    # processes a host: the ranks' host threads share its cores
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dev = f"cuda:{rank}" if device == "cuda" else "cpu"
    mesh = init_distributed(device=dev,
                            init_method=f"tcp://localhost:{port}")
    traffic = cell.traffic
    recipe = _recipe(cell, os.path.join(tmp, f"rank{rank}"))
    os.makedirs(os.path.join(tmp, f"rank{rank}"), exist_ok=True)
    rowset = texts.triplets(seed, traffic["triplets"],
                            tuple(traffic["query_words"]),
                            tuple(traffic["doc_words"]))
    data_file = os.path.join(tmp, f"rank{rank}", "train_000.jsonl")
    with open(data_file, "w", encoding="utf-8") as f:
        for row in rowset:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    recipe["data"]["train_files"] = [data_file]
    data = load_training_data(recipe["data"]["train_files"])
    tok = texts.CharTokenizer(cell.config["vocab_size"])
    cfg = V33Config.from_dict(recipe)
    weights = make_weights(cell.config, seed, mesh.device)
    model = SpladeEncoder(model_config(cell, "train_v33"),
                          pool_impl="kernel", with_token_weights=False,
                          device=mesh.device)
    model.mlm.load_state_dict(weights)
    collator = TripletCollator(
        tok, query_max_length=cfg.data.query_max_length,
        doc_max_length=cfg.data.doc_max_length,
        num_hard_negatives=cfg.data.num_hard_negatives)
    trainer = Trainer(cfg, model, data, collator, device=mesh.device,
                      mesh=mesh)
    params = program_names(trainer.model.named_parameters())
    masks = ("query_attention_mask", "positive_attention_mask",
             "negative_attention_mask")
    probe = AgreedProbe(
        trainer, params, weights,
        tokens=lambda b: sum(b[k].sum() for k in masks),
        capture=lambda b: {k: b[k].cpu() for k in
                           ("query_input_ids", "positive_input_ids")},
        mesh=mesh)
    probe.lengths_of = lambda b: {k: b[k].sum(-1) for k in masks}
    reduce_ms = []
    if trace and mesh.is_main:
        probe.after_step = lambda n: reduce_ms.append(
            trainer.reducer.last_ms if trainer.reducer is not None else None)
    cfg.training.max_steps = CHECKED_STEPS
    trainer.train_epoch(1)
    sync()
    prog_losses = [float(x) for x in probe.losses]
    if trainer.state.step != CHECKED_STEPS:
        raise RuntimeError(f"set-up stopped at step {trainer.state.step}")
    setup_s = now() - t_start

    win, context, trace_out = train_window(
        probe, trace and mesh.is_main, tmp, seconds,
        lambda n: setattr(cfg.training, "max_steps", n))
    peak = peak_bytes()
    tokens = host_sum(win["tokens"], mesh)
    log(f"rank {rank}: window {win['steps']} steps, {win['tokens']:.0f} "
        f"tokens in {win['window_s']:.3f} s; all ranks {tokens:.0f} tokens")
    context.update(model=cell.config, kind="v33", allreduce_ms=reduce_ms)
    captured = probe.batches
    grad1, change = probe.grad1_norms, probe.change_norms
    del trainer, model, probe, params, data, collator, weights
    free_cache()

    steps, unknown = rows_of(rowset, tok, captured,
                             recipe["data"]["query_max_length"])
    ref = reference_readings(cell, seed, rowset, tok, steps, mesh, recipe)
    unknown = int(host_sum(unknown, mesh))
    readings = train_readings(prog_losses, ref["losses"], grad1,
                              ref["grad1"], change, ref["change"])
    readings.update(rows_unknown=unknown)
    if mesh.is_main:
        log(f"losses program {prog_losses} reference {ref['losses']}; "
            f"worst gradient leaf {readings['_grad_leaf']}, worst change "
            f"leaf {readings['_update_leaf']}")
    dist.barrier(group=mesh.host_group)
    dist.destroy_process_group()
    return Outcome(
        metrics={"train_tokens_per_s": tokens / win["window_s"],
                 "setup_s": setup_s},
        attempted=win["steps"], failed=0,
        checks=checks(readings, traffic["limits"]),
        memory_peak_bytes=peak, context=context, trace=trace_out)


def host_sum(x: float, mesh) -> float:
    """The sum of ``x`` over ranks, on the host group."""
    import torch.distributed as dist

    t = torch.tensor([float(x)], dtype=torch.float64)
    if mesh.distributed:
        dist.all_reduce(t, group=mesh.host_group)
    return float(t)


def reference_readings(cell, seed, rowset, tok, steps, mesh, recipe,
                       mm_name: str = "f32", keep_rows=None) -> dict:
    """The reference's optimizer steps, as ``train_v33.reference_readings``
    on this rank's rows (``steps``: each step's micro-batches), the
    ranks' summed gradients divided by the world size before each step
    (DDP's average) and each step's loss averaged over ranks. With no
    process group (``mesh.distributed`` False) one process takes every
    rank's micro-batches of a step itself. The schedule is that of the
    cell's global batch."""
    import torch.distributed as dist

    from perfbench.reference import precision
    from perfbench.reference.splade import v33_micro_grads
    from perfbench.reference.train import Reference, warmup_cosine

    precision.tf32_off()
    device = mesh.device
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

    ranks = mesh.world if mesh.distributed else 1
    batch = data["batch_size"] * cell.traffic["ranks"]
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
        if mesh.distributed:
            for n in ref.leaves:
                g = ref.p[n].grad
                if g is None:
                    ref.p[n].grad = g = torch.zeros_like(ref.p[n])
                dist.all_reduce(g)
        losses.append(host_sum(total, mesh) / (len(micro) * ranks))
        got = ref.apply(len(micro) * ranks)
        if s == 0:
            grad1 = {n: float(g.double().norm()) for n, g in got.items()}
    change = {n: float((ref.p[n].detach() - initial[n]).double().norm())
              for n in ref.leaves}
    return {"losses": losses, "grad1": grad1, "change": change}


def worker(spec_path: str, rank: int) -> int:
    """A rank's process: its share of the run that rank 0 started."""
    with open(spec_path) as f:
        spec = json.load(f)
    bench.set_cache_dirs()
    cell = bench.Cell(name=spec["name"], chips=spec["chips"],
                      config=spec["config"], config_name=spec["config_name"],
                      traffic=spec["traffic"],
                      traffic_name=spec["traffic_name"], end_to_end=[],
                      per_layer=[])
    rank_run(cell, spec["seed"], spec["seconds"], False, spec["device"],
             spec["tmp"], now(), rank, cell.traffic["ranks"], spec["port"])
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] != "worker":
        raise SystemExit(f"usage: {sys.argv[0]} worker SPEC RANK")
    sys.exit(worker(sys.argv[2], int(sys.argv[3])))
