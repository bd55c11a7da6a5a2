"""V33 configuration dataclasses (a copy of ``splade_tpu/config/v33.py``).

The same sections, keys and defaults as the JAX package, so one YAML file
configures both trainers. Where a key means something else on the GPU, its
docstring says how the port reads it: ``model.dtype`` selects autocast,
``model.remat`` recomputes whole layers, ``model.fused_splade_head`` picks
the pool (the hand-written kernels by default), ``mesh.num_data`` is the
number of data-parallel ranks (processes of ``torch.distributed``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List


@dataclass
class V33ModelConfig:
    """Model/backbone knobs (reference: src/train/config/v33.py:24-29)."""

    name: str = "skt/A.X-Encoder-base"
    dropout: float = 0.1
    # additions of the JAX package ----------------------------------------
    dtype: str = "bfloat16"
    """Compute dtype for activations (params are always float32): in the
    port, 'bfloat16' runs the step under torch.autocast(bfloat16)."""
    remat: bool = True
    """Recompute each encoder layer in the backward pass
    (torch.utils.checkpoint) to trade operations for device memory."""
    remat_policy: str = "dots_no_batch"
    """JAX's remat policy. torch has no counterpart of 'dots_no_batch'
    (save the dense projections, recompute attention), so the port
    recomputes whole layers under either value."""
    fused_splade_head: str = "auto"
    """'auto' | 'fused' | 'xla': how to compute the 50K-vocab projection +
    masked max-pool. In the port 'auto' and 'fused' take the hand-written
    kernels (pool_impl 'kernel'; the JAX trainer's 'auto' takes its
    XLA-streamed path, with the same numbers); 'xla' = the reference-shaped
    full-logits path for parity testing."""
    attention_impl: str = "sdpa"
    """'sdpa' | 'splash': 'splash' takes the port's sliding-window +
    segment-id flash attention kernels (ops/splash_attention.py), the
    counterpart of the JAX package's Pallas splash attention; unlike that
    one it runs at every sequence length and has no fallback to sdpa."""
    packed_query_tower: bool = True
    """Pack doc_len//query_len queries per doc-shaped row (segment-masked
    attention, per-segment RoPE) and run queries + docs as ONE backbone
    forward per micro-batch. Same math as the unpacked path; falls back
    when doc_max_length is not a multiple of query_max_length."""


@dataclass
class V33LossConfig:
    """Loss knobs (reference: src/train/config/v33.py:32-62)."""

    lambda_q: float = 1e-2
    lambda_d: float = 3e-3
    temperature: float = 1.0
    flops_warmup_steps: int = 20000
    lambda_kd: float = 0.0
    kd_temperature: float = 1.0
    lambda_margin_mse: float = 0.0
    lambda_initial_ratio: float = 0.1
    lambda_neg: float = 0.0
    """0 = fall back to lambda_d (reference: src/model/losses.py:50)."""
    # additions of the JAX package ----------------------------------------
    global_in_batch_negatives: bool = False
    """If True, InfoNCE sees the whole batch as candidates (num_blocks 1).
    The reference is per-rank only (reference: src/model/losses.py:152-181);
    False reproduces that."""


@dataclass
class V33DataConfig:
    """Data knobs (reference: src/train/config/v33.py:65-86)."""

    train_files: List[str] = field(default_factory=lambda: ["data/v29.0/train_*.jsonl"])
    val_files: List[str] = field(default_factory=lambda: ["data/v29.0/val.jsonl"])
    batch_size: int = 64
    """Per-rank batch size (reference per-GPU batch)."""
    query_max_length: int = 64
    doc_max_length: int = 256
    num_workers: int = 4
    num_hard_negatives: int = 1
    # additions of the JAX package ----------------------------------------
    tokenizer_path: str = ""
    """HF tokenizer dir/name. Empty = resolve via SPLADE_TOKENIZER_PATH env
    or the model name."""
    length_buckets: List[float] = field(default_factory=list)
    """Optional sequence-length buckets as fractions of max (e.g.
    [0.25, 0.5, 1.0]): each batch pads to the smallest fitting bucket
    instead of always max_length. Empty = always pad to max."""
    prefetch_depth: int = 2
    """Host-side collation prefetch depth for the input pipeline."""
    device_prefetch_depth: int = 2
    """Host-to-device double-buffering: a background thread pins the next
    N macro batches while the current step computes, and the loop copies
    them to the card without blocking (0 disables)."""


@dataclass
class V33TrainingConfig:
    """Trainer knobs (reference: src/train/config/v33.py:89-104)."""

    num_epochs: int = 25
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.06
    gradient_clip: float = 1.0
    gradient_accumulation_steps: int = 4
    mixed_precision: str = "bf16"
    output_dir: str = "outputs/train_v33"
    log_every_n_steps: int = 50
    save_every_n_epochs: int = 5
    seed: int = 42
    eval_every_n_epochs: int = 5
    max_steps: int = 0
    """0 = no cap; >0 caps total optimizer steps (debug/smoke runs)."""
    watchdog_timeout_s: float = 0.0
    """>0 arms the hang watchdog (train/preemption.py): the process exits
    with code 17 when no step completes on the card within this many
    seconds. Size it above the first step's kernel build plus checkpoint
    and eval pauses."""


@dataclass
class V33MeshConfig:
    """Data-parallel layout — no reference counterpart (DDP handled this)."""

    data_axis: str = "data"
    num_data: int = -1
    """-1 (or 0) = every rank of the process group, one process a GPU under
    torchrun (1 without a process group). Each rank computes the loss on
    its own ``data.batch_size`` rows, so the global batch is ``batch_size x
    world``; any other value than the world size is refused."""


@dataclass
class V33Config:
    """Top-level V33 config (reference: src/train/config/v33.py:107-132)."""

    model: V33ModelConfig = field(default_factory=V33ModelConfig)
    loss: V33LossConfig = field(default_factory=V33LossConfig)
    data: V33DataConfig = field(default_factory=V33DataConfig)
    training: V33TrainingConfig = field(default_factory=V33TrainingConfig)
    mesh: V33MeshConfig = field(default_factory=V33MeshConfig)

    def __post_init__(self) -> None:
        for name, cls in (
            ("model", V33ModelConfig),
            ("loss", V33LossConfig),
            ("data", V33DataConfig),
            ("training", V33TrainingConfig),
            ("mesh", V33MeshConfig),
        ):
            val = getattr(self, name)
            if isinstance(val, dict):
                known = {f.name for f in dataclasses.fields(cls)}
                unknown = set(val) - known
                if unknown:
                    # reference semantics: unknown keys are dropped, not a
                    # crash — but say so (typo'd env vars land here)
                    import logging

                    logging.getLogger(__name__).warning(
                        "config section %r: ignoring unknown keys %s",
                        name, sorted(unknown))
                setattr(self, name,
                        cls(**{k: v for k, v in val.items() if k in known}))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "V33Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
