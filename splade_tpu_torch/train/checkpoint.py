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
never leaves a truncated checkpoint that resume would pick up. Given the
``mesh`` of a data-parallel run, rank 0 alone writes (the parameters and
optimizer state are the same on every rank), and every rank waits at a
barrier until the write is done, so none goes on to read a checkpoint half
written.

``load_model_state`` reads a model's weights from either format: the port's
``model.pt``, or the JAX package's ``model.msgpack`` (flax msgpack) through
``read_msgpack_params`` and ``models/hf_port.params_from_jax``. Optimizer
state is not carried across: a msgpack checkpoint gives a model, never a
resumed run.
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from splade_tpu_torch.parallel.mesh import DataMesh, barrier
from splade_tpu_torch.train.state import TrainState

logger = logging.getLogger(__name__)

MODEL_FILE = "model.pt"
STATE_FILE = "training_state.pt"
MSGPACK_FILE = "model.msgpack"  # the JAX package's parameter file


def _atomic_save(obj: Any, path: Path) -> None:
    buf = io.BytesIO()
    torch.save(obj, buf)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(buf.getvalue())
    os.replace(tmp, path)


def save_checkpoint(output_dir: str, state: TrainState, cfg=None,
                    epoch: int = 0, best: Optional[float] = None,
                    name: Optional[str] = None,
                    mesh: DataMesh = DataMesh()) -> str:
    """Write the checkpoint (rank 0 of ``mesh`` only) -> its path, on every
    rank."""
    ckpt_name = name or f"checkpoint_epoch{epoch}_step{state.step}"
    path = Path(output_dir) / ckpt_name
    if mesh.is_main:
        _write_checkpoint(path, state, cfg, epoch, best)
    barrier(mesh)
    return str(path)


def _write_checkpoint(path: Path, state: TrainState, cfg, epoch: int,
                      best: Optional[float]) -> None:
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


def save_final_model(output_dir: str, model, tokenizer=None,
                     prefix: str = "", mesh: DataMesh = DataMesh()) -> str:
    """Final artifact (reference: train_v33_ddp.py:721-730), written by
    rank 0 of ``mesh`` only. ``prefix`` is put before every key: the MLM pre-trainer
    saves its bare model under ``mlm.``, the name it has inside a
    ``SpladeEncoder``."""
    path = Path(output_dir) / "final_model"
    if mesh.is_main:
        path.mkdir(parents=True, exist_ok=True)
        _atomic_save({prefix + k: v for k, v in model.state_dict().items()},
                     path / MODEL_FILE)
        if tokenizer is not None and hasattr(tokenizer, "save_pretrained"):
            tokenizer.save_pretrained(str(path))
    barrier(mesh)
    return str(path)


def _msgpack_array(data: bytes) -> np.ndarray:
    """One flax-msgpack array leaf: msgpack of (shape, dtype name, bytes).
    bfloat16 (which numpy lacks) is read as 16-bit words and widened to
    float32 exactly: its bits are a float32's upper half."""
    import msgpack

    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        return words.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _msgpack_ext(code: int, data: bytes):
    """flax's extension types: 1 an array, 3 a numpy scalar packed as a
    0-d array, 2 a complex number as (real, imag)."""
    import msgpack

    if code == 1:
        return _msgpack_array(data)
    if code == 3:
        return _msgpack_array(data)[()]
    if code == 2:
        return complex(*msgpack.unpackb(data))
    raise ValueError(f"unknown msgpack extension type {code}")


def _unchunk(tree):
    """flax splits an array above 2**30 bytes into flat chunks under a
    marker key; join them back."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack_params(path) -> Dict[str, Any]:
    """A flax-msgpack file (``flax.serialization.to_bytes`` of a parameter
    tree) as nested dicts of numpy arrays, without flax: nested maps with
    string keys, arrays as an extension type. The ``msgpack`` package is
    imported here only; without it this raises ImportError."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "reading a model.msgpack checkpoint needs the 'msgpack' "
            "package") from e
    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=_msgpack_ext,
                           raw=False, strict_map_key=False)
    return _unchunk(tree)


def load_model_state(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint or final-model dir as a state dict of
    ``ModernBertForMaskedLM`` (HF names, no ``mlm.`` prefix), from the
    port's ``model.pt`` (saved from a ``SpladeEncoder`` or from the bare MLM
    model) or from the JAX package's ``model.msgpack``."""
    d = Path(ckpt_dir)
    if (d / MODEL_FILE).exists():
        state = torch.load(d / MODEL_FILE, map_location="cpu",
                           weights_only=True)
        if all(k.startswith("mlm.") for k in state):
            state = {k[len("mlm."):]: v for k, v in state.items()}
        return state
    if (d / MSGPACK_FILE).exists():
        from splade_tpu_torch.models.hf_port import params_from_jax

        return params_from_jax(read_msgpack_params(d / MSGPACK_FILE))
    raise FileNotFoundError(
        f"no {MODEL_FILE} or {MSGPACK_FILE} under {ckpt_dir}")


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
