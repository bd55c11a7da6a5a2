"""Korean MLM pre-training tier (port of ``splade_tpu/train/mlm.py``).

The reference ships ``configs/pretrain_mlm.yaml`` for a trainer module that
no longer exists there; the JAX package rebuilt it, and this is its
counterpart on one GPU or data parallel over ``torch.distributed``:

- **Dynamic masking on the device** — the 15% BERT masking (80% ``[MASK]``
  / 10% random / 10% keep) is drawn per micro-batch from a
  ``torch.Generator`` on the model's device, seeded from (seed, step,
  micro-batch index): every epoch sees fresh masks, and a resumed step
  draws what the uninterrupted one drew. The draws (``MaskDraws``) are kept
  apart from what is done with them (``apply_mlm_masking``), so the same
  draws give the same masking as the JAX function. The bits themselves
  cannot equal ``jax.random``'s.
- **Masked-position gather before the vocab projection** — the 50K-vocab
  head is applied only to the selected positions (``[B, P, V]`` instead of
  ``[B, S, V]``). That product is a plain ``torch.matmul``, as the JAX
  package leaves it to XLA.
- **Sequence packing** — sentences are concatenated into full fixed-length
  rows instead of padded.
- The step is the V33 trainer's: gradient accumulation, the AdamW,
  warmup-cosine schedule and clipping of ``train/state.py``, bf16 autocast
  over f32 parameters under ``dtype: bfloat16``.
- Data parallel, as the V33 trainer (``train/trainer.py``): each rank
  takes its contiguous ``batch_size`` rows of every micro-batch of the
  global batch (``batch_size x world``), its masks are its rows of the
  draws over the whole global micro-batch, and its cross-entropy is
  normalised by the global count of masked positions (one all-reduce of
  the count, without a gradient), scaled so that the gradient all-reduce's
  SUM divided by the world size gives the global batch's mean and its
  gradient: what one process computes at the global batch.

Checkpoints hold the bare MLM model; the final model is saved under the
``mlm.`` prefix (``save_final_model(..., prefix="mlm.")``), so the V33
trainer's ``--checkpoint`` and ``SparseEncoderV33.from_checkpoint`` load it
as a ``SpladeEncoder``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Union

import numpy as np
import torch

from splade_tpu_torch.config.v33 import V33TrainingConfig
from splade_tpu_torch.parallel.mesh import (DataMesh, GradReducer,
                                            all_reduce_mean, all_reduce_sum,
                                            broadcast_params_)
from splade_tpu_torch.train.preemption import (HangWatchdog, heartbeat_if_due,
                                               install_preemption_handler,
                                               stop_agreed)
from splade_tpu_torch.train.state import TrainState, create_train_state
from splade_tpu_torch.utils.runtime import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Config (keys mirror reference configs/pretrain_mlm.yaml)
# --------------------------------------------------------------------------
@dataclass
class MLMConfig:
    model_name: str = "skt/A.X-Encoder-base"
    data_dir: str = "data/mlm_korean"
    max_length: int = 512
    output_dir: str = "outputs/pretrain_mlm"
    epochs: int = 3
    batch_size: int = 32
    grad_accum: int = 4
    lr: float = 5e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.05
    mlm_probability: float = 0.15
    save_steps: int = 2000
    eval_steps: int = 1000
    logging_steps: int = 100
    dataloader_workers: int = 4
    seed: int = 42
    # additions of the JAX package -------------------------------------------
    tokenizer_path: str = ""
    max_steps: int = 0
    val_fraction: float = 0.01
    """Held-out packed rows for masked-LM eval (fixed mask generator)."""
    remat: bool = False
    """Recompute each encoder layer in the backward pass."""
    dtype: str = "bfloat16"
    """'bfloat16' runs the model under torch.autocast(bfloat16) over f32
    parameters; 'float32' computes in f32."""
    attention_impl: str = "sdpa"
    """'sdpa' | 'splash' (the flash attention kernels of
    ops/splash_attention.py, at every max_length; see
    V33ModelConfig.attention_impl)."""
    watchdog_timeout_s: float = 0.0
    """>0 arms the hang watchdog (see V33TrainingConfig.watchdog_timeout_s)."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def load(cls, path: Optional[str],
             overrides: Optional[Dict[str, Any]] = None) -> "MLMConfig":
        """YAML <- env (``MLM_<KEY>``) <- explicit overrides. PyYAML is
        imported only when a YAML path is given."""
        d: Dict[str, Any] = {}
        if path:
            import yaml

            with open(path) as f:
                d.update(yaml.safe_load(f) or {})
        fields = {f.name: f.default for f in dataclasses.fields(cls)}
        for name, default in fields.items():
            env = os.environ.get(f"MLM_{name.upper()}")
            if env is None:
                continue
            if isinstance(default, bool):
                d[name] = env.lower() in ("1", "true", "yes")
            elif isinstance(default, int):
                d[name] = int(env)
            elif isinstance(default, float):
                d[name] = float(env)
            else:
                d[name] = env
        d.update(overrides or {})
        unknown = set(d) - set(fields)
        if unknown:
            raise ValueError(f"unknown MLM config keys: {sorted(unknown)}")
        return cls(**d)


# --------------------------------------------------------------------------
# Corpus packing
# --------------------------------------------------------------------------
def read_corpus(data_dir: str) -> Iterator[str]:
    """Yield sentences from mlm_*.txt shards (scripts/prepare_korean_mlm_data.py
    output) or from *.jsonl files with a ``text`` field."""
    paths = sorted(glob.glob(os.path.join(data_dir, "mlm_*.txt")))
    paths += sorted(glob.glob(os.path.join(data_dir, "*.jsonl")))
    if not paths:
        raise FileNotFoundError(f"no mlm_*.txt or *.jsonl under {data_dir}")
    for p in paths:
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("{"):
                    try:
                        line = json.loads(line).get("text", "")
                    except json.JSONDecodeError:
                        pass
                if line:
                    yield line


def pack_corpus(sentences, tokenizer, max_length: int,
                batch_tokenize: int = 512) -> np.ndarray:
    """Pack tokenized sentences into full [N, max_length] rows.

    Layout per row: ``[CLS] tok tok ... [SEP]`` with sentences concatenated
    back to back; a sentence crossing the boundary spills into the next row.
    Only the final row can carry padding (the reference pads every sample
    to 512 instead).
    """
    cls_id, sep_id = tokenizer.cls_token_id, tokenizer.sep_token_id
    pad_id = tokenizer.pad_token_id or 0
    body = max_length - 2
    rows: List[np.ndarray] = []
    cur: List[int] = []
    buf: List[str] = []

    def flush_batch():
        nonlocal cur
        if not buf:
            return
        enc = tokenizer(buf, add_special_tokens=False)["input_ids"]
        buf.clear()
        for ids in enc:
            cur.extend(ids)
            while len(cur) >= body:
                rows.append(np.array([cls_id] + cur[:body] + [sep_id], np.int32))
                cur = cur[body:]

    for s in sentences:
        buf.append(s)
        if len(buf) >= batch_tokenize:
            flush_batch()
    flush_batch()
    if cur:
        tail = [cls_id] + cur + [sep_id]
        tail += [pad_id] * (max_length - len(tail))
        rows.append(np.array(tail, np.int32))
    if not rows:
        raise ValueError("empty MLM corpus")
    return np.stack(rows)


# --------------------------------------------------------------------------
# Masking + loss
# --------------------------------------------------------------------------
class MaskDraws(NamedTuple):
    """The random numbers one micro-batch's masking consumes."""

    scores: torch.Tensor      # [B, S] f32 uniform in [1e-6, 1): position picks
    op: torch.Tensor          # [B, P] f32 uniform in [0, 1): the 80/10/10 split
    rand_tokens: torch.Tensor  # [B, P] int64 uniform in [0, vocab)


def mask_seed(seed: int, step: int, micro: int) -> int:
    """One generator seed per (run seed, optimizer step, micro-batch index):
    a pure function of the three, so a resumed step draws what the
    uninterrupted one drew."""
    return ((seed * 1_000_003 + step) * 1_000_003 + micro) % (2 ** 63)


def draw_mask_randoms(generator: torch.Generator, B: int, S: int, P: int,
                      vocab_size: int) -> MaskDraws:
    """The draws of ``apply_mlm_masking`` (``splade_tpu/train/mlm.py:195-203``:
    position scores, the corruption uniform, the random tokens), on the
    generator's device."""
    dev = generator.device
    scores = torch.rand((B, S), generator=generator, device=dev,
                        dtype=torch.float32) * (1.0 - 1e-6) + 1e-6
    op = torch.rand((B, P), generator=generator, device=dev,
                    dtype=torch.float32)
    rand_tokens = torch.randint(0, vocab_size, (B, P), generator=generator,
                                device=dev)
    return MaskDraws(scores, op, rand_tokens)


def apply_mlm_masking(draws: MaskDraws, ids: torch.Tensor,
                      eligible: torch.Tensor, P: int, mask_token_id: int):
    """BERT dynamic masking from given draws.

    Selects exactly ``P`` positions per row, the highest of the uniform
    scores restricted to eligible positions (ineligible picks, in rows with
    fewer than P eligible tokens, get weight 0; equal scores take the lower
    index first, as ``lax.top_k``), then corrupts 80% to ``[MASK]``, 10% to
    a random token, 10% kept.

    Returns (corrupted_ids [B,S], positions [B,P], labels [B,P], weights [B,P]).
    """
    scores = draws.scores * eligible
    positions = torch.sort(scores, dim=1, descending=True,
                           stable=True).indices[:, :P]           # [B, P]
    weights = torch.gather(eligible, 1, positions)
    labels = torch.gather(ids, 1, positions)
    mask_tok = torch.full_like(labels, mask_token_id)
    corrupted_val = torch.where(
        draws.op < 0.8, mask_tok,
        torch.where(draws.op < 0.9, draws.rand_tokens.to(labels.dtype),
                    labels))
    corrupted_val = torch.where(weights > 0, corrupted_val, labels)
    corrupted = ids.scatter(1, positions, corrupted_val)
    return corrupted, positions, labels, weights


def masked_positions_per_row(mlm_prob: float, max_length: int) -> int:
    return max(int(round(mlm_prob * (max_length - 2))), 1)


def make_mlm_loss_fn(model, mask_token_id: int, vocab_size: int,
                     special_ids, pad_id: int, mlm_prob: float,
                     max_length: int, autocast=contextlib.nullcontext):
    """Loss over one micro-batch {input_ids [B,S]} with masking on the
    device: ``loss_fn(micro, rng, count=None, world=1, rank=0) -> (loss,
    metrics)``, ``rng`` a ``torch.Generator`` on the batch's device or
    ready ``MaskDraws``.

    P = round(mlm_prob * (max_length - 2)) positions are selected per row
    among the eligible (non-special, non-pad) ones; the encoder runs on the
    corrupted ids, the P selected states are gathered, and the head and the
    tied projection run on [B, P, H] only.

    As rank ``rank`` of ``world``: a generator draws over the global
    micro-batch [world * B, S] and this rank keeps its rows' draws;
    ``count`` maps this rank's count of masked positions to the global one
    (an all-reduce), and the loss and accuracy are ``world`` times this
    rank's sum over the global count, so their mean over ranks is the
    global batch's. ``loss_fn.mask`` is the masking alone: (corrupted ids,
    attention mask, positions, labels, weights)."""
    P = masked_positions_per_row(mlm_prob, max_length)
    specials = np.asarray(special_ids, np.int64).reshape(-1)

    def mask(micro: Dict[str, torch.Tensor],
             rng: Union[torch.Generator, MaskDraws], world: int = 1,
             rank: int = 0):
        ids = micro["input_ids"].long()
        B, S = ids.shape
        attn = ids != pad_id
        is_special = torch.isin(ids, torch.as_tensor(specials,
                                                     device=ids.device))
        eligible = (attn & ~is_special).to(torch.float32)
        if isinstance(rng, MaskDraws):
            draws = rng
        else:
            draws = draw_mask_randoms(rng, world * B, S, P, vocab_size)
            if world > 1:
                draws = MaskDraws(*(d[rank * B:(rank + 1) * B]
                                    for d in draws))
        corrupted, positions, labels, weights = apply_mlm_masking(
            draws, ids, eligible, P, mask_token_id)
        return corrupted, attn, positions, labels, weights

    def loss_fn(micro: Dict[str, torch.Tensor],
                rng: Union[torch.Generator, MaskDraws], count=None,
                world: int = 1, rank: int = 0):
        corrupted, attn, positions, labels, weights = mask(micro, rng, world,
                                                           rank)
        B = corrupted.shape[0]
        with autocast():
            hidden = model.encode(corrupted, attn.long())           # [B,S,H]
            sel = torch.gather(hidden, 1, positions[:, :, None].expand(
                -1, -1, hidden.shape[-1]))                          # [B,P,H]
            logits = model.project_vocab(model.head_transform(sel))  # [B,P,V]
        logits = logits.to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
        total = weights.sum()
        if count is not None:
            total = count(total.detach())
        denom = total + 1e-6
        loss = (ce * weights).sum() / denom * world
        acc = ((logits.argmax(-1) == labels) * weights).sum() / denom * world
        return loss, {"mlm_acc": acc.detach(),
                      "masked_per_row": (denom / (B * world)).detach()}

    loss_fn.mask = mask
    return loss_fn


def make_mlm_train_step(accum: int, loss_fn, seed: int,
                        gradient_clip: float = 1.0,
                        mesh: Optional[DataMesh] = None):
    """(TrainState, batch {input_ids [accum, B, S]} on the device) ->
    metrics dict of device scalars; the state advances by one optimizer
    step. The V33 step's structure (``train/trainer.py``): gradients summed
    over ``accum`` micro-batches, averaged, clipped by global norm, one
    AdamW and one schedule step. Micro-batch i of optimizer step s masks
    from ``mask_seed(seed, s, i)``. ``mesh`` with a process group: the
    batch is this rank's rows, the count of masked positions, the gradients
    and the metrics are reduced over ranks (``train_step.reducer``)."""
    distributed = mesh is not None and mesh.distributed
    reducer = GradReducer(mesh) if distributed else None
    rank_args = dict(count=lambda t: all_reduce_sum(t, mesh),
                     world=mesh.world, rank=mesh.rank) if distributed else {}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        model = state.model
        ids = batch["input_ids"]
        if ids.shape[0] != accum:
            raise ValueError(f"batch holds {ids.shape[0]} micro-batches, "
                             f"grad_accum is {accum}")
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        sums: Dict[str, torch.Tensor] = {}
        for i in range(accum):
            gen = torch.Generator(device=ids.device).manual_seed(
                mask_seed(seed, state.step, i))
            loss, metrics = loss_fn({"input_ids": ids[i]}, gen, **rank_args)
            loss.backward()
            for k, v in {"loss": loss.detach(), **metrics}.items():
                sums[k] = v if k not in sums else sums[k] + v
        params = [p for p in model.parameters() if p.grad is not None]
        for p in params:
            p.grad.div_(accum)
        if reducer is not None:
            reducer([p.grad for p in params])
        torch.nn.utils.clip_grad_norm_(params, gradient_clip)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        out = {k: v / accum for k, v in sums.items()}
        return all_reduce_mean(out, mesh) if distributed else out

    train_step.reducer = reducer
    return train_step


def _as_training_cfg(cfg: MLMConfig) -> V33TrainingConfig:
    return V33TrainingConfig(
        num_epochs=cfg.epochs, learning_rate=cfg.lr,
        weight_decay=cfg.weight_decay, warmup_ratio=cfg.warmup_ratio,
        gradient_accumulation_steps=cfg.grad_accum, seed=cfg.seed,
        output_dir=cfg.output_dir, max_steps=cfg.max_steps)


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------
class MLMTrainer:
    """Epoch loop of MLM pre-training: ``model`` is a
    ``ModernBertForMaskedLM``, ``rows`` the packed corpus
    (``pack_corpus``). It runs on ``cuda`` unless the caller passes
    ``device="cpu"``; ``mesh`` is this rank's place in a data-parallel run
    (``init_distributed``), None one process. Rank 0 alone writes metrics
    and checkpoints."""

    def __init__(self, cfg: MLMConfig, model, rows: np.ndarray, tokenizer,
                 device: DeviceLike = None, mesh: Optional[DataMesh] = None):
        from splade_tpu_torch.utils.logging import MetricWriter
        from splade_tpu_torch.utils.metrics import MetricsTracker

        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh or DataMesh(device=self.device)
        self.model = model.to(self.device)
        broadcast_params_(self.model, self.mesh)
        self.tokenizer = tokenizer
        self.global_batch = cfg.batch_size * self.mesh.world
        self.accum = cfg.grad_accum

        n_val = max(int(len(rows) * cfg.val_fraction), 0)
        # the packed tail row (only padded row) goes to val when there is one
        self.val_rows = rows[len(rows) - n_val:] if n_val else rows[:0]
        self.train_rows = rows[:len(rows) - n_val]
        rows_per_step = self.global_batch * self.accum
        if len(self.train_rows) < rows_per_step:
            raise ValueError(
                f"corpus too small: {len(self.train_rows)} packed rows < one "
                f"optimizer step of {rows_per_step}")
        self.steps_per_epoch = len(self.train_rows) // rows_per_step
        self.total_steps = self.steps_per_epoch * cfg.epochs
        if cfg.max_steps:
            self.total_steps = min(self.total_steps, cfg.max_steps)

        tcfg = _as_training_cfg(cfg)
        self.state = create_train_state(self.model, tcfg, self.total_steps)
        special_ids = np.asarray(sorted(set(tokenizer.all_special_ids)),
                                 np.int64)
        self.loss_fn = make_mlm_loss_fn(
            self.model, tokenizer.mask_token_id, len(tokenizer), special_ids,
            tokenizer.pad_token_id or 0, cfg.mlm_probability, cfg.max_length,
            autocast=self._autocast)
        self.step_fn = make_mlm_train_step(self.accum, self.loss_fn, cfg.seed,
                                           tcfg.gradient_clip, mesh=self.mesh)
        self.reducer = self.step_fn.reducer  # None without a process group
        self.writer = MetricWriter(f"{cfg.output_dir}/tb",
                                   enabled=self.mesh.is_main)
        self.tracker = MetricsTracker(cfg.output_dir, best_metric="loss",
                                      enabled=self.mesh.is_main)
        self.start_epoch = 1
        self._preempted = False
        self._watchdog: Optional[HangWatchdog] = None  # armed by train()

    def _autocast(self):
        if self.cfg.dtype == "bfloat16":
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def install_preemption_handler(self) -> dict:
        """SIGTERM/SIGINT -> checkpoint at the next step boundary. Main
        thread only; returns the handlers it replaced."""
        return install_preemption_handler(self)

    def _epoch_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """This rank's rows ([accum, batch_size, S]) of each step's global
        batch ([accum, batch_size x world, S], the JAX trainer's)."""
        rng = np.random.default_rng(self.cfg.seed + epoch)
        order = rng.permutation(len(self.train_rows))
        rows_per_step = self.global_batch * self.accum
        lo = self.mesh.rank * self.cfg.batch_size
        for i in range(self.steps_per_epoch):
            sel = order[i * rows_per_step:(i + 1) * rows_per_step]
            ids = self.train_rows[sel].reshape(
                self.accum, self.global_batch, -1)
            yield {"input_ids": ids[:, lo:lo + self.cfg.batch_size]}

    def _to_device(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids)).to(self.device)

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Masked-LM loss/accuracy on held-out rows with a fixed mask
        generator (seed 0 for every batch)."""
        if not len(self.val_rows):
            return {}
        B = self.cfg.batch_size
        n_val = len(self.val_rows)
        # a held-out set smaller than one batch runs as one small batch:
        # its rows were carved out of training and must not go unread
        chunks = ([self.val_rows] if n_val < B else
                  [self.val_rows[i:i + B]
                   for i in range(0, n_val - B + 1, B)])
        was_training = self.model.training
        self.model.eval()
        losses, accs = [], []
        for chunk in chunks:
            gen = torch.Generator(device=self.device).manual_seed(0)
            loss, m = self.loss_fn({"input_ids": self._to_device(chunk)}, gen)
            losses.append(float(loss))
            accs.append(float(m["mlm_acc"]))
        self.model.train(was_training)
        mean_loss = float(np.mean(losses))
        return {"mlm_loss": mean_loss, "mlm_acc": float(np.mean(accs)),
                "perplexity": float(np.exp(min(mean_loss, 20.0)))}

    def train(self) -> TrainState:
        from splade_tpu_torch.train.checkpoint import save_checkpoint

        cfg = self.cfg
        logger.info(
            "MLM pretraining: %d epochs x %d steps (batch %d = %d x %d ranks, "
            "accum %d, seq %d, %d packed rows) on %s",
            cfg.epochs, self.steps_per_epoch, self.global_batch,
            cfg.batch_size, self.mesh.world, self.accum, cfg.max_length,
            len(self.train_rows), self.device)
        self._watchdog = HangWatchdog(cfg.watchdog_timeout_s, name="mlm")
        self._last_epoch = self.start_epoch
        try:
            self._train_epochs(save_checkpoint)
            # the final save still reads the card: keep the watchdog armed
            save_checkpoint(cfg.output_dir, self.state, cfg,
                            epoch=self._last_epoch,
                            best=self.tracker.best_value, mesh=self.mesh)
        finally:
            # an exception must not leave the armed watchdog alive: exit 17
            # would tell a restart supervisor to resume a run that aborted
            self._watchdog.stop()
        self.tracker.summary()
        self.writer.close()
        return self.state

    def _train_epochs(self, save_checkpoint) -> None:
        cfg = self.cfg
        t0 = time.time()
        run_start_step = self.state.step  # exclude pre-resume steps
        tokens_per_step = self.global_batch * self.accum * cfg.max_length
        for epoch in range(self.start_epoch, cfg.epochs + 1):
            # Exact mid-epoch resume: batch order is a pure function of
            # (seed, epoch) and the mask generator of (seed, step, micro),
            # so skipping the consumed steps reproduces the uninterrupted
            # run bitwise.
            done_in_epoch = self.state.step - (epoch - 1) * self.steps_per_epoch
            for i, batch in enumerate(self._epoch_batches(epoch)):
                if i < done_in_epoch:
                    continue
                if stop_agreed(self) or (cfg.max_steps and self.state.step
                                         >= cfg.max_steps):
                    break
                metrics = self.step_fn(
                    self.state,
                    {"input_ids": self._to_device(batch["input_ids"])})
                gstep = self.state.step
                heartbeat_if_due(self._watchdog, metrics["loss"])
                if gstep % cfg.logging_steps == 0 or gstep == 1:
                    host = {k: float(v) for k, v in metrics.items()}
                    self._watchdog.beat()  # float() proved a completed step
                    if not np.isfinite(host["loss"]):
                        raise FloatingPointError(
                            f"non-finite MLM loss at step {gstep}")
                    host["epoch"] = epoch
                    host["tokens_per_sec"] = (
                        tokens_per_step * (gstep - run_start_step)
                        / max(time.time() - t0, 1e-9))
                    if self.reducer is not None:
                        host["allreduce_ms"] = self.reducer.last_ms
                    self.tracker.log(gstep, host)
                    self.writer.scalars(host, gstep, prefix="train/")
                    logger.info(
                        "epoch %d step %d/%d loss %.4f acc %.3f %.0f tok/s",
                        epoch, gstep, self.total_steps, host["loss"],
                        host["mlm_acc"], host["tokens_per_sec"])
                if cfg.eval_steps and gstep % cfg.eval_steps == 0:
                    scores = self.evaluate()
                    if scores:
                        self.writer.scalars(scores, gstep, prefix="eval/")
                        logger.info("eval @ step %d: %s", gstep, scores)
                        # beat only when eval ran on the card (an empty
                        # val set returns {} without touching it)
                        self._watchdog.beat()
                if cfg.save_steps and gstep % cfg.save_steps == 0:
                    save_checkpoint(cfg.output_dir, self.state, cfg,
                                    epoch=epoch, best=self.tracker.best_value,
                                    mesh=self.mesh)
                    self._watchdog.beat()  # so is a checkpoint write
            self._last_epoch = epoch
            if stop_agreed(self) or (cfg.max_steps
                                     and self.state.step >= cfg.max_steps):
                break


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser("splade-tpu-torch MLM pretrainer")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torch.distributed: one process "
                        "a GPU under torchrun (NCCL; gloo with --device cpu)")
    args = p.parse_args(argv)

    from splade_tpu_torch.parallel.mesh import init_distributed

    # the rank's device is made current before anything touches a card
    mesh = (init_distributed(args.device) if args.distributed
            else DataMesh(device=resolve_device(args.device)))
    try:
        return _pretrain(args, mesh)
    finally:
        if mesh.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _pretrain(args, mesh: DataMesh) -> int:
    device = mesh.device
    overrides = {k: v for k, v in {
        "data_dir": args.data_dir, "output_dir": args.output_dir,
        "epochs": args.epochs, "batch_size": args.batch_size,
        "lr": args.lr, "max_steps": args.max_steps,
        "tokenizer_path": args.tokenizer,
    }.items() if v is not None}
    cfg = MLMConfig.load(args.config, overrides)

    from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                    ModernBertForMaskedLM)
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                   load_checkpoint,
                                                   save_final_model)
    from splade_tpu_torch.train.cli import refuse_divergent_resume
    from splade_tpu_torch.utils.logging import setup_logging
    from splade_tpu_torch.utils.tokenizer import create_tokenizer

    setup_logging(os.path.join(cfg.output_dir, "training.log"),
                  is_main_process=mesh.is_main)
    if mesh.is_main:
        Path(cfg.output_dir).mkdir(parents=True, exist_ok=True)
        (Path(cfg.output_dir) / "resolved_config.json").write_text(
            json.dumps(cfg.to_dict(), indent=2))
    logger.info("device: %s (rank %d of %d)", device, mesh.rank, mesh.world)

    tokenizer = create_tokenizer(cfg.tokenizer_path or cfg.model_name)
    logger.info("packing corpus from %s ...", cfg.data_dir)
    rows = pack_corpus(read_corpus(cfg.data_dir), tokenizer, cfg.max_length)
    logger.info("packed %d rows of %d tokens", len(rows), cfg.max_length)

    mconfig = ModernBertConfig(vocab_size=len(tokenizer), remat=cfg.remat,
                               attention_impl=cfg.attention_impl,
                               pad_token_id=tokenizer.pad_token_id)
    # the SPLADE wrapper's seeded initialiser, then its MLM model alone
    model: ModernBertForMaskedLM = SpladeEncoder(
        mconfig, device=device).init_weights(cfg.seed).mlm
    logger.info("params: %.1fM",
                sum(x.numel() for x in model.parameters()) / 1e6)

    trainer = MLMTrainer(cfg, model, rows, tokenizer, device=device,
                         mesh=mesh)
    trainer.install_preemption_handler()
    ckpt = args.checkpoint
    if args.resume and not ckpt:
        ckpt = find_latest_checkpoint(cfg.output_dir)
    refuse_divergent_resume(ckpt, mesh)
    if ckpt:
        trainer.state, meta = load_checkpoint(ckpt, trainer.state)
        if meta["full_resume"]:
            trainer.start_epoch = min(
                trainer.state.step // trainer.steps_per_epoch + 1, cfg.epochs)
        logger.info("restored %s (full_resume=%s, start_epoch=%d)",
                    ckpt, meta["full_resume"], trainer.start_epoch)

    t0 = time.time()
    state = trainer.train()
    logger.info("MLM pretraining done in %.1f min", (time.time() - t0) / 60)
    # under the mlm. prefix, so the V33 SPLADE trainer loads it directly
    save_final_model(cfg.output_dir, state.model, tokenizer, prefix="mlm.",
                     mesh=mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
