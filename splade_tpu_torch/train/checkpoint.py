"""Checkpoint save/load with the reference's dual resume semantics, in the
port's own format (port of ``splade_tpu/train/checkpoint.py``).

Layout (reference: src/train/cli/train_v33_ddp.py:192-286):

    {output_dir}/checkpoint_epoch{E}_step{S}/
        model.pt           — the model's state dict (torch.save)
        training_state.pt  — optimizer, schedule, step, epoch, best_metric
        config.json        — resolved run config
    {output_dir}/final_model/model.pt (+ tokenizer files)

- ``--resume``: find the latest complete checkpoint by step suffix, restore
  the model, optimizer and schedule.
- ``--checkpoint PATH`` on a model-only dir: load the model, start fresh at
  epoch 1 (how V34/V35 fine-tune from V33's final model).

Every file is written to a temporary name and renamed, so a crash mid-write
never leaves a truncated checkpoint that resume would pick up. Reading the
JAX package's msgpack checkpoints is ROADMAP.md §1 item 2.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from splade_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

MODEL_FILE = "model.pt"
STATE_FILE = "training_state.pt"


def _atomic_save(obj: Any, path: Path) -> None:
    buf = io.BytesIO()
    torch.save(obj, buf)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(buf.getvalue())
    os.replace(tmp, path)


def save_checkpoint(output_dir: str, state: TrainState, cfg=None,
                    epoch: int = 0, best: Optional[float] = None,
                    name: Optional[str] = None) -> str:
    ckpt_name = name or f"checkpoint_epoch{epoch}_step{state.step}"
    path = Path(output_dir) / ckpt_name
    path.mkdir(parents=True, exist_ok=True)
    _atomic_save(state.model.state_dict(), path / MODEL_FILE)
    _atomic_save({
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
        "epoch": epoch,
        "best_metric": float(best) if best is not None else 0.0,
    }, path / STATE_FILE)
    if cfg is not None:
        tmp = path / "config.json.tmp"
        tmp.write_text(json.dumps(cfg.to_dict(), indent=2))
        os.replace(tmp, path / "config.json")
    logger.info("saved checkpoint %s", path)
    return str(path)


def save_final_model(output_dir: str, model, tokenizer=None) -> str:
    """Final artifact (reference: train_v33_ddp.py:721-730)."""
    path = Path(output_dir) / "final_model"
    path.mkdir(parents=True, exist_ok=True)
    _atomic_save(model.state_dict(), path / MODEL_FILE)
    if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
        tokenizer.save_pretrained(str(path))
    return str(path)


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def load_checkpoint(ckpt_dir: str, state: TrainState
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore into ``state`` -> (state, meta). Model-only dirs restore the
    model and leave the optimizer fresh (meta['full_resume'] False)."""
    d = Path(ckpt_dir)
    dev = _device(state)
    state.model.load_state_dict(torch.load(d / MODEL_FILE, map_location=dev,
                                           weights_only=True))
    ts_path = d / STATE_FILE
    if not ts_path.exists():
        return state, {"full_resume": False, "epoch": 0, "step": 0}
    ts = torch.load(ts_path, map_location=dev, weights_only=True)
    state.optimizer.load_state_dict(ts["optimizer"])
    state.scheduler.load_state_dict(ts["scheduler"])
    state.step = int(ts["step"])
    meta = {"full_resume": True, "epoch": int(ts["epoch"]),
            "step": state.step, "best_metric": ts["best_metric"]}
    return state, meta


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    """Latest by trailing step number (reference: train_v33_ddp.py:276-286),
    skipping checkpoints a crash left incomplete (model written but the
    training state missing): resuming one would silently restart the
    optimizer at epoch 1."""
    root = Path(output_dir)
    if not root.exists():
        return None
    best_step, best_path = -1, None
    for p in root.glob("checkpoint_*"):
        m = re.search(r"step(\d+)$", p.name)
        if not (p / MODEL_FILE).exists() or not (p / STATE_FILE).exists():
            continue
        if m and int(m.group(1)) > best_step:
            best_step, best_path = int(m.group(1)), p
    return str(best_path) if best_path else None
