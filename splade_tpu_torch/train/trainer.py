"""Train step + epoch-loop Trainer (port of ``splade_tpu/train/trainer.py``).

One optimizer step takes ``accum`` micro-batches: each runs forward and
backward (gradients summed in the parameters' f32 ``.grad``), then the sum
is divided by ``accum``, its global norm taken (the logged ``grad_norm``),
clipped, and one AdamW step and one schedule step follow. Positives and
hard negatives share one doc-tower forward, and with the packed query
tower the queries ride in the same stream. The model computes under
``torch.autocast(bfloat16)`` when ``model.dtype`` is ``bfloat16``; the loss
is computed in f32 outside it, as JAX computes it from f32 vectors.

The step count lives on the host, so the loop never waits on the card
except on log steps, where it reads the loss (and raises on a non-finite
one), and once per half window of an armed hang watchdog
(``train/preemption.py``). A SIGTERM or SIGINT caught by the CLI's handler
sets ``_preempted``: the loop stops at the next step boundary, writes a
checkpoint and returns. Mid-epoch resume is exact: the loader's order is a pure function of
(seed, epoch) and the step draws no random numbers, so skipping the macro
batches already consumed reproduces the uninterrupted run bitwise.

Data parallel (``torch.distributed``, one process a GPU under torchrun):
each rank loads ``data.batch_size`` rows of every micro-batch (its slice of
the epoch's order), runs its ``accum`` micro-batches with the loss of its
own rows (num_blocks 1), divides by ``accum``, and the step then takes one
gradient all-reduce (``parallel/mesh.py``: SUM, divided by the world size)
before clipping and AdamW; the metrics are averaged the same way. Rank 0's
parameters are broadcast once at construction. The ranks agree at every
step boundary whether any of them was signalled to stop
(``preemption.stop_agreed``), so all stop at the same step. Rank 0 alone
writes metrics and checkpoints.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from splade_tpu_torch.config.v33 import V33Config, V33LossConfig
from splade_tpu_torch.losses.v33 import v33_loss
from splade_tpu_torch.parallel.mesh import (DataMesh, GradReducer,
                                            all_reduce_mean,
                                            broadcast_params_)
from splade_tpu_torch.train.preemption import (HangWatchdog, heartbeat_if_due,
                                               install_preemption_handler,
                                               stop_agreed)
from splade_tpu_torch.train.state import TrainState, create_train_state
from splade_tpu_torch.utils.logging import MetricWriter
from splade_tpu_torch.utils.metrics import (MetricsTracker, MovingAverage,
                                            compute_throughput)
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

# Batch keys that enter the device step ([accum, B, ...] after stacking).
TENSOR_KEYS = (
    "query_input_ids", "query_attention_mask",
    "positive_input_ids", "positive_attention_mask",
    "negative_input_ids", "negative_attention_mask",
    "teacher_pos_scores", "teacher_neg_scores", "teacher_scores",
)


def stack_microbatches(micro_batches: List[Dict[str, Any]]
                       ) -> Dict[str, np.ndarray]:
    """[accum] list of collated batches -> dict of [accum, ...] arrays.

    Length-bucketed collation can give micro-batches different sequence
    lengths; they are right-padded to the group max (mask 0, id 0 — padded
    positions are masked out of every reduction)."""
    out = {}
    for k in TENSOR_KEYS:
        present = [k in mb for mb in micro_batches]
        if not any(present):
            continue
        if not all(present):
            # teacher-score keys appear only when a micro-batch's EVERY row
            # carries complete scores: partially-labeled KD for one step is
            # worse than none, so the key is dropped for this step
            logger.warning(
                "dropping %s for this step: present in %d/%d micro-batches "
                "(dataset mixes teacher-scored and unscored rows)",
                k, sum(present), len(micro_batches))
            continue
        arrs = [np.asarray(mb[k]) for mb in micro_batches]
        if arrs[0].ndim == 2 and len({a.shape[1] for a in arrs}) > 1:
            S = max(a.shape[1] for a in arrs)
            arrs = [np.pad(a, ((0, 0), (0, S - a.shape[1]))) for a in arrs]
        out[k] = np.stack(arrs)
    return out


def pin_batch(macro: Dict[str, np.ndarray], pin: bool) -> Dict[str, torch.Tensor]:
    """Host batch -> CPU tensors, page-locked when ``pin`` (a copy from
    pinned memory can run without blocking the host)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in macro.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def to_device(batch: Dict[str, torch.Tensor], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Copy a (pinned) host batch to ``device`` on the current stream, so
    the step that reads it is ordered after the copy."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


class DevicePrefetcher:
    """Background-thread input pipeline: prepare batch N+1..N+depth while
    step N computes.

    ``transfer`` maps a host batch to what the loop consumes; in the
    Trainer it only pins host memory. The copy to the card is issued by the
    loop thread (``to_device``) on the compute stream: a copy issued here,
    on another stream the compute stream never waits on, would race the
    step that reads it. Exceptions propagate to the consumer; close()
    unblocks and joins the worker without draining the source iterator.
    """

    def __init__(self, batches: Iterable, transfer: Callable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._src = batches

        def worker():
            try:
                for b in batches:
                    if not self._put(("ok", transfer(b))):
                        return
                self._put(("end", None))
            except BaseException as e:  # noqa: BLE001 - relayed to consumer
                self._put(("err", e))

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        while True:
            kind, val = self._q.get()
            if kind == "ok":
                yield val
            elif kind == "end":
                return
            else:
                raise val

    def close(self) -> None:
        """Stop the worker (the consumer left early: max_steps)."""
        self._stop.set()
        while True:  # drain so a blocked put() observes the stop flag
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        # Close the abandoned source generator AFTER the worker has
        # returned (a generator cannot be closed while executing): its
        # finally stops the dataloader's own prefetch producer, which
        # would otherwise keep collating (and tokenizing) until its queue
        # filled.
        if not self._thread.is_alive():
            close = getattr(self._src, "close", None)
            if close is not None:
                close()


def compute_autocast(model_cfg, device: torch.device):
    """The model's compute dtype as an autocast context: bf16 under
    ``dtype: bfloat16`` (f32 parameters, bf16 products), else none."""
    if model_cfg.dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def make_loss_fn(model, loss_cfg: V33LossConfig, num_blocks: int,
                 packed_query: bool = False, autocast=contextlib.nullcontext,
                 mesh: Optional[DataMesh] = None):
    """(micro-batch of device tensors, step) -> (loss, LossMetrics). The
    packed forward runs when ``Sd % Sq == 0 and Sd > Sq``. ``mesh``: see
    ``v33_loss`` (global in-batch negatives across ranks)."""

    def loss_fn(micro: Dict[str, torch.Tensor], step: int):
        B, Sq = micro["query_input_ids"].shape
        doc_ids = torch.cat([micro["positive_input_ids"],
                             micro["negative_input_ids"]])
        doc_mask = torch.cat([micro["positive_attention_mask"],
                              micro["negative_attention_mask"]])
        Sd = doc_ids.shape[1]
        with autocast():
            if packed_query and Sd % Sq == 0 and Sd > Sq:
                (q_repr, _), (doc_repr, _) = model.forward_packed_qd(
                    micro["query_input_ids"], micro["query_attention_mask"],
                    doc_ids, doc_mask)
            else:
                q_repr, _ = model(micro["query_input_ids"],
                                  micro["query_attention_mask"])
                doc_repr, _ = model(doc_ids, doc_mask)
        p_repr = doc_repr[:B]
        n_repr = doc_repr[B:].reshape(B, -1, doc_repr.shape[-1])
        return v33_loss(
            q_repr, p_repr, n_repr, step, loss_cfg,
            teacher_scores=micro.get("teacher_scores"),
            teacher_pos_scores=micro.get("teacher_pos_scores"),
            teacher_neg_scores=micro.get("teacher_neg_scores"),
            num_blocks=num_blocks, mesh=mesh,
        )

    return loss_fn


def make_train_step(cfg: V33Config, num_blocks: int = 1,
                    mesh: Optional[DataMesh] = None):
    """(TrainState, batch of [accum, B, ...] device tensors) -> metrics dict
    of device scalars; the state's parameters, optimizer, schedule and step
    advance by one optimizer step. ``num_blocks`` > 1 gives one process
    the loss of that many ranks over their concatenated rows; ``mesh`` with
    a process group makes this the step of one rank (its own rows, the
    gradients and metrics reduced over ranks; ``train_step.reducer`` holds
    the reduction and its last time)."""
    accum = cfg.training.gradient_accumulation_steps
    clip = cfg.training.gradient_clip
    reducer = GradReducer(mesh) if mesh is not None and mesh.distributed \
        else None

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        model = state.model
        device = next(model.parameters()).device
        loss_fn = make_loss_fn(
            model, cfg.loss, num_blocks,
            packed_query=cfg.model.packed_query_tower,
            autocast=lambda: compute_autocast(cfg.model, device), mesh=mesh)
        n_micro = next(iter(batch.values())).shape[0]
        if n_micro != accum:
            raise ValueError(f"batch holds {n_micro} micro-batches, "
                             f"gradient_accumulation_steps is {accum}")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        metric_sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            loss, metrics = loss_fn(micro, state.step)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in metrics.as_dict().items():
                v = v.detach()
                metric_sums[k] = v if k not in metric_sums else metric_sums[k] + v
        params = [p for p in model.parameters() if p.grad is not None]
        for p in params:
            p.grad.div_(accum)
        if reducer is not None:
            reducer([p.grad for p in params])
        grad_norm = torch.nn.utils.clip_grad_norm_(params, clip)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        out = {"loss": loss_sum / accum}
        out.update({k: v / accum for k, v in metric_sums.items()})
        out["grad_norm"] = grad_norm.detach()
        if reducer is not None:
            out = all_reduce_mean(out, mesh)
        return out

    train_step.reducer = reducer
    return train_step


def check_num_data(num_data: int, mesh: DataMesh) -> None:
    """``mesh.num_data`` -1 or 0 takes the world size; another value must
    be it."""
    if num_data > 0 and num_data != mesh.world:
        raise ValueError(
            f"mesh.num_data {num_data} is not the world size {mesh.world} "
            "(one rank a GPU under torchrun; -1 takes the world size)")


class Trainer:
    """Epoch loop: data order, logging, eval, checkpointing (reference flow:
    train_v33_ddp.py:451-736). ``mesh`` is this rank's place in a
    data-parallel run (``init_distributed``), None one process.
    The evaluator runs on every rank (replicated parameters); rank 0
    writes."""

    def __init__(
        self,
        cfg: V33Config,
        model,
        train_data,
        collator,
        val_data=None,
        evaluator=None,
        output_dir: Optional[str] = None,
        device: DeviceLike = None,
        mesh: Optional[DataMesh] = None,
    ):
        from splade_tpu_torch.data.pipeline import create_dataloader

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh or DataMesh(device=self.device)
        check_num_data(cfg.mesh.num_data, self.mesh)
        self.model = model.to(self.device)
        broadcast_params_(self.model, self.mesh)
        self.output_dir = output_dir or cfg.training.output_dir
        if evaluator is None and val_data is not None:
            from splade_tpu_torch.train.eval import MidTrainingEvaluator

            evaluator = MidTrainingEvaluator(list(val_data), collator)
        self.evaluator = evaluator
        if self.mesh.world > 1 and getattr(collator, "length_buckets", None):
            # a bucket is chosen from each rank's own rows, so the ranks'
            # shapes (and step times) would differ: pad to max, as the JAX
            # trainer does on a pod
            logger.warning("data parallel: disabling length bucketing "
                           "(content-dependent shapes differ across ranks)")
            collator.length_buckets = None
        self.global_batch = cfg.data.batch_size * self.mesh.world
        self.accum = cfg.training.gradient_accumulation_steps
        self.loader = create_dataloader(
            train_data, collator, cfg.data.batch_size, shuffle=True,
            seed=cfg.training.seed, drop_last=True,
            process_index=self.mesh.rank, process_count=self.mesh.world,
            prefetch_depth=cfg.data.prefetch_depth)
        self.steps_per_epoch = max(len(self.loader) // self.accum, 1)
        self.total_steps = self.steps_per_epoch * cfg.training.num_epochs
        if cfg.training.max_steps:
            self.total_steps = min(self.total_steps, cfg.training.max_steps)
        self.state = create_train_state(self.model, cfg.training,
                                        self.total_steps)
        self.step_fn = make_train_step(cfg, mesh=self.mesh)
        self.reducer = self.step_fn.reducer  # None without a process group
        # rank-0 metric sinks (reference: train_v33_ddp.py:377-442)
        self.writer = MetricWriter(f"{self.output_dir}/tb",
                                   enabled=self.mesh.is_main)
        self.tracker = MetricsTracker(self.output_dir, best_metric="loss",
                                      enabled=self.mesh.is_main)
        self.ema_nonzero_q = MovingAverage(0.9)
        self.ema_nonzero_d = MovingAverage(0.9)
        self.start_epoch = 1
        self._preempted = False
        self._watchdog: Optional[HangWatchdog] = None  # armed by train()

    def install_preemption_handler(self) -> dict:
        """SIGTERM/SIGINT -> checkpoint at the next step boundary. Main
        thread only; returns the handlers it replaced."""
        return install_preemption_handler(self)

    def _macro_batches(self, epoch: int, skip_macros: int = 0
                       ) -> Iterable[Dict[str, np.ndarray]]:
        self.loader.set_epoch(epoch, skip_batches=skip_macros * self.accum)
        bucket: List[Dict[str, Any]] = []
        for mb in self.loader:
            bucket.append(mb)
            if len(bucket) == self.accum:
                yield stack_microbatches(bucket)
                bucket = []

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        t0 = time.time()
        done_in_epoch = max(
            0, self.state.step - (epoch - 1) * self.steps_per_epoch)
        macros = self._macro_batches(epoch, skip_macros=done_in_epoch)
        pin = self.device.type == "cuda"
        depth = self.cfg.data.device_prefetch_depth
        prefetcher = None
        if depth > 0:
            prefetcher = DevicePrefetcher(
                macros, lambda m: pin_batch(m, pin), depth=depth)
            batches: Iterable = prefetcher
        else:
            batches = (pin_batch(m, pin) for m in macros)
        try:
            return self._run_steps(batches, epoch, t0)
        finally:
            if prefetcher is not None:
                prefetcher.close()

    def _run_steps(self, batches: Iterable, epoch: int,
                   t0: float) -> Dict[str, float]:
        cfg = self.cfg.training
        last: Dict[str, float] = {}
        samples = 0
        wd = self._watchdog
        for host_batch in batches:
            if stop_agreed(self):
                break
            if cfg.max_steps and self.state.step >= cfg.max_steps:
                break
            metrics = self.step_fn(self.state,
                                   to_device(host_batch, self.device))
            samples += self.global_batch * self.accum
            gstep = self.state.step
            heartbeat_if_due(wd, metrics["loss"])
            if gstep % cfg.log_every_n_steps == 0 or gstep == 1:
                host = {k: float(v) for k, v in metrics.items()}
                # float() waited until the card finished this step: the
                # completed compute the watchdog's heartbeat stands for
                if wd is not None:
                    wd.beat()
                if not np.isfinite(host["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss at step {gstep}: {host} — "
                        "stopping before the checkpoint is poisoned")
                host["epoch"] = epoch
                host["samples_per_sec"] = compute_throughput(
                    samples, time.time() - t0)
                self.ema_nonzero_q.update(host["nonzero_q"])
                self.ema_nonzero_d.update(host["nonzero_d"])
                host["nonzero_q_ema"] = self.ema_nonzero_q.get()
                host["nonzero_d_ema"] = self.ema_nonzero_d.get()
                if self.reducer is not None:
                    host["allreduce_ms"] = self.reducer.last_ms
                self.tracker.log(gstep, host)
                self.writer.scalars(host, gstep, prefix="train/")
                logger.info(
                    "epoch %d step %d loss %.4f infonce %.4f nnz(q/d) "
                    "%.0f/%.0f %.0f samp/s", epoch, gstep, host["loss"],
                    host["infonce"], host["nonzero_q"], host["nonzero_d"],
                    host["samples_per_sec"])
                last = host
        return last

    def evaluate(self) -> Dict[str, float]:
        with compute_autocast(self.cfg.model, self.device):
            return self.evaluator.evaluate(self.model)

    def train(self) -> TrainState:
        from splade_tpu_torch.train.checkpoint import save_checkpoint

        cfg = self.cfg.training
        logger.info(
            "training: %d epochs x %d steps (batch %d = %d x %d ranks, "
            "accum %d) on %s", cfg.num_epochs, self.steps_per_epoch,
            self.global_batch, self.cfg.data.batch_size, self.mesh.world,
            self.accum, self.device)
        flat = {}
        for section, vals in self.cfg.to_dict().items():
            if isinstance(vals, dict):
                flat.update({f"{section}.{k}": v for k, v in vals.items()
                             if isinstance(v, (int, float, str, bool))})
        flat["device"] = str(self.device)
        flat["global_batch"] = self.global_batch
        self.writer.hparams(flat)
        # Hang watchdog: trips (hard exit for a restart supervisor) when no
        # step COMPLETES within the window; stopped on every way out, so an
        # exception a caller catches leaves no armed thread behind.
        self._watchdog = HangWatchdog(cfg.watchdog_timeout_s)
        try:
            for epoch in range(self.start_epoch, cfg.num_epochs + 1):
                t0 = time.time()
                self.train_epoch(epoch)
                logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)
                # a signal may have reached one rank during the epoch's
                # last step: every rank takes the same branch below
                if stop_agreed(self):
                    save_checkpoint(self.output_dir, self.state, self.cfg,
                                    epoch=epoch, best=self.tracker.best_value,
                                    mesh=self.mesh)
                    logger.warning("preemption checkpoint written; exiting")
                    break
                if (self.evaluator is not None
                        and epoch % cfg.eval_every_n_epochs == 0):
                    scores = self.evaluate()
                    self.writer.scalars(scores, self.state.step,
                                        prefix="eval/")
                    logger.info("eval @ epoch %d: %s", epoch, scores)
                    if scores:  # only a non-empty eval ran on the card
                        self._watchdog.beat()
                if (epoch % cfg.save_every_n_epochs == 0
                        or epoch == cfg.num_epochs):
                    save_checkpoint(self.output_dir, self.state, self.cfg,
                                    epoch=epoch, best=self.tracker.best_value,
                                    mesh=self.mesh)
                    self._watchdog.beat()  # the save read the parameters
                if cfg.max_steps and self.state.step >= cfg.max_steps:
                    break
        finally:
            self._watchdog.stop()
        self.tracker.summary()
        self.writer.close()
        return self.state
