"""Train state + optimizer: AdamW with no-decay groups and warmup-cosine LR.

Port of ``splade_tpu/train/state.py``, whose optax chain is

    clip_by_global_norm(gradient_clip) -> adamw(schedule, 0.9, 0.999, 1e-8,
                                                weight_decay, mask=decay_mask)

Here: ``torch.optim.AdamW`` with two parameter groups (no decay on
LayerNorm weights and biases, the decoder bias included — reference:
train_v33_ddp.py:560-581), ``clip_grad_norm_`` before each step (the train
step's job), and a ``LambdaLR`` that reproduces
``optax.warmup_cosine_decay_schedule``: linear warmup from 0 over
``max(int(total_steps · warmup_ratio), 1)`` steps, then cosine decay to 0.
Like optax's, the schedule is read at the count of updates already made,
so the first update has learning rate 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch
from torch import nn
from torch.optim.lr_scheduler import LambdaLR

from splade_tpu_torch.config.v33 import V33TrainingConfig


@dataclass
class TrainState:
    """What a step changes and a checkpoint keeps: the model's parameters,
    the optimizer and schedule, and the count of optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: LambdaLR
    step: int = 0


def decays(name: str) -> bool:
    """True where weight decay APPLIES: everything except LayerNorm weights
    and biases (the decoder bias among them) — the JAX ``decay_mask``."""
    return not (name.endswith("bias") or name.endswith("norm.weight"))


def param_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    decay, no_decay = [], []
    for name, p in model.named_parameters():  # the tied embedding once
        if p.requires_grad:
            (decay if decays(name) else no_decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def warmup_cosine_schedule(learning_rate: float, total_steps: int,
                           warmup_ratio: float = 0.06
                           ) -> Callable[[int], float]:
    """step -> learning rate, as ``optax.warmup_cosine_decay_schedule(0,
    learning_rate, warmup, max(total_steps, warmup + 1), 0)``."""
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps, warmup + 1) - warmup

    def lr(step: int) -> float:
        if step < warmup:
            return learning_rate * step / warmup
        count = min(step - warmup, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * count / decay))

    return lr


def create_optimizer(model: nn.Module, cfg: V33TrainingConfig,
                     total_steps: int
                     ) -> Tuple[torch.optim.Optimizer, LambdaLR]:
    optimizer = torch.optim.AdamW(
        param_groups(model, cfg.weight_decay), lr=cfg.learning_rate,
        betas=(0.9, 0.999), eps=1e-8)
    sched = warmup_cosine_schedule(cfg.learning_rate, total_steps,
                                   cfg.warmup_ratio)
    peak = cfg.learning_rate
    scheduler = LambdaLR(optimizer,
                         lambda step: sched(step) / peak if peak else 0.0)
    return optimizer, scheduler


def create_train_state(model: nn.Module, cfg: V33TrainingConfig,
                       total_steps: int) -> TrainState:
    optimizer, scheduler = create_optimizer(model, cfg, total_steps)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler)
