"""Training CLI (port of ``splade_tpu/train/cli.py``, with its flags).

Usage:

    python -m splade_tpu_torch.train v33 --config configs/train_v33.yaml \
        [--epochs N] [--batch-size B] [--lr LR] [--output-dir DIR]
        [--lambda-q X] [--lambda-d X] [--grad-accum N] [--seed S]
        [--debug] [--resume] [--checkpoint PATH] [--max-samples N]
        [--tokenizer PATH] [--device cuda|cpu] [--distributed]

    torchrun --nproc_per_node N -m splade_tpu_torch.train v33 \
        --distributed --config configs/train_v33.yaml

CLI flags override env which overrides YAML which overrides defaults
(reference: train_v33_ddp.py:123-156); ``--config`` also reads the JSON
that a run writes as ``resolved_config.json``. It trains on one GPU
(``cuda``) unless ``--device cpu`` is given, and raises when there is no
card. ``--distributed`` trains data parallel over ``torch.distributed``,
one process a GPU (``cuda:{LOCAL_RANK}``, NCCL; gloo with ``--device
cpu``): ``data.batch_size`` is per rank, rank 0 logs and writes, and a
resume checkpoint that differs across ranks is refused.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict, Optional

from splade_tpu_torch.utils.tokenizer import create_tokenizer

logger = logging.getLogger(__name__)

#: model.fused_splade_head -> SpladeEncoder.pool_impl: the port's default
#: pool is the hand-written kernels
POOL_MAPPING = {"auto": "kernel", "fused": "kernel", "xla": "logits"}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("splade-tpu-torch v33 trainer")
    p.add_argument("--config", type=str, default=None,
                   help="a YAML config, or a .json one (save_config's)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--output-dir", type=str, default=None)
    p.add_argument("--lambda-q", type=float, default=None)
    p.add_argument("--lambda-d", type=float, default=None)
    p.add_argument("--grad-accum", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--debug", action="store_true",
                   help="cap at 100 steps / 1 epoch (reference --debug)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--max-samples", type=int, default=0)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda)")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over torch.distributed: one process "
                        "a GPU under torchrun (NCCL; gloo with --device cpu)")
    return p


def overrides_from_args(args: argparse.Namespace) -> Dict[str, Any]:
    ov: Dict[str, Dict[str, Any]] = {"model": {}, "loss": {}, "data": {},
                                     "training": {}}
    if args.epochs is not None:
        ov["training"]["num_epochs"] = args.epochs
    if args.batch_size is not None:
        ov["data"]["batch_size"] = args.batch_size
    if args.lr is not None:
        ov["training"]["learning_rate"] = args.lr
    if args.output_dir is not None:
        ov["training"]["output_dir"] = args.output_dir
    if args.lambda_q is not None:
        ov["loss"]["lambda_q"] = args.lambda_q
    if args.lambda_d is not None:
        ov["loss"]["lambda_d"] = args.lambda_d
    if args.grad_accum is not None:
        ov["training"]["gradient_accumulation_steps"] = args.grad_accum
    if args.seed is not None:
        ov["training"]["seed"] = args.seed
    if args.tokenizer is not None:
        ov["data"]["tokenizer_path"] = args.tokenizer
    if args.debug:
        ov["training"]["num_epochs"] = 1
        ov["training"]["max_steps"] = 100
    return {k: v for k, v in ov.items() if v}


def refuse_divergent_resume(ckpt: Optional[str], mesh) -> None:
    """Every rank restores the checkpoint itself (rank 0 wrote it; sound on
    a shared filesystem). Ranks that would restore different ones, or only
    some of them one, would train diverged replicas: refuse, on every rank
    (``splade_tpu/train/cli.py:152-167``)."""
    from splade_tpu_torch.parallel.mesh import same_on_all_ranks

    if not same_on_all_ranks(ckpt or "", mesh):
        raise RuntimeError(
            f"resume checkpoint differs across ranks (rank {mesh.rank} "
            f"sees {ckpt!r}): output_dir must be one shared filesystem")


def main(argv: Optional[list] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from splade_tpu_torch.parallel.mesh import DataMesh, init_distributed
    from splade_tpu_torch.utils.runtime import resolve_device

    # the rank's device is made current before anything touches a card
    mesh = (init_distributed(args.device) if args.distributed
            else DataMesh(device=resolve_device(args.device)))
    try:
        return _train(args, mesh)
    finally:
        if mesh.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args: argparse.Namespace, mesh) -> int:
    from splade_tpu_torch.config import load_config, save_config
    from splade_tpu_torch.data import TripletCollator, load_training_data
    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder
    from splade_tpu_torch.train.checkpoint import (find_latest_checkpoint,
                                                   load_checkpoint,
                                                   save_final_model)
    from splade_tpu_torch.train.eval import MidTrainingEvaluator
    from splade_tpu_torch.train.trainer import Trainer
    from splade_tpu_torch.utils.logging import setup_logging

    device = mesh.device
    cfg = load_config(args.config, overrides=overrides_from_args(args))
    out_dir = cfg.training.output_dir
    setup_logging(os.path.join(out_dir, "training.log"),
                  is_main_process=mesh.is_main)
    if mesh.is_main:
        save_config(cfg, os.path.join(out_dir, "resolved_config.json"))
    logger.info("device: %s (rank %d of %d)", device, mesh.rank, mesh.world)
    if cfg.model.fused_splade_head not in POOL_MAPPING:
        raise ValueError(
            f"model.fused_splade_head: {cfg.model.fused_splade_head!r} "
            f"(choose from {sorted(POOL_MAPPING)})")

    tokenizer = create_tokenizer(cfg.data.tokenizer_path or cfg.model.name)
    train_data = load_training_data(cfg.data.train_files,
                                    max_samples=args.max_samples)
    collator = TripletCollator(
        tokenizer,
        query_max_length=cfg.data.query_max_length,
        doc_max_length=cfg.data.doc_max_length,
        num_hard_negatives=cfg.data.num_hard_negatives,
        length_buckets=cfg.data.length_buckets or None,
    )
    mconfig = ModernBertConfig(vocab_size=len(tokenizer),
                               pad_token_id=tokenizer.pad_token_id,
                               remat=cfg.model.remat,
                               attention_impl=cfg.model.attention_impl)
    model = SpladeEncoder(
        mconfig, pool_impl=POOL_MAPPING[cfg.model.fused_splade_head],
        with_token_weights=False, device=device,
    ).init_weights(cfg.training.seed)
    logger.info("params: %.1fM",
                sum(p.numel() for p in model.parameters()) / 1e6)

    evaluator = None
    try:
        val_data = load_training_data(cfg.data.val_files)
        evaluator = MidTrainingEvaluator(list(val_data), collator)
    except FileNotFoundError:
        logger.info("no val files; mid-training eval disabled")

    trainer = Trainer(cfg, model, train_data, collator, evaluator=evaluator,
                      output_dir=out_dir, device=device, mesh=mesh)
    trainer.install_preemption_handler()
    ckpt = args.checkpoint
    if args.resume and not ckpt:
        ckpt = find_latest_checkpoint(out_dir)
    refuse_divergent_resume(ckpt, mesh)
    if ckpt:
        trainer.state, meta = load_checkpoint(ckpt, trainer.state)
        if meta["full_resume"]:
            # position from the step counter: mid-epoch exact resume
            trainer.start_epoch = min(
                trainer.state.step // trainer.steps_per_epoch + 1,
                cfg.training.num_epochs)
        logger.info("restored %s (full_resume=%s, start_epoch=%d)",
                    ckpt, meta["full_resume"], trainer.start_epoch)

    t0 = time.time()
    state = trainer.train()
    logger.info("training done in %.1f min", (time.time() - t0) / 60)
    save_final_model(out_dir, state.model, tokenizer, mesh=mesh)
    return 0
