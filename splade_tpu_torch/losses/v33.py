"""V33 SPLADE training loss in PyTorch (port of ``splade_tpu/losses/v33.py``).

Reference semantics: src/model/losses.py:14-301 (SPLADELossV33).

    L = InfoNCE + λ_q(t)·FLOPS(q) + λ_d(t)·FLOPS(p) + λ_neg(t)·FLOPS(n)
        [+ λ_kd·KL + λ_mmse·MarginMSE]

As in the JAX package: hard negatives always carry an explicit k axis
[B, k, V]; the loss is written over the whole batch, and ``num_blocks``
reproduces per-rank data-parallel semantics on it (InfoNCE and KD
candidates masked to the caller's contiguous block, FLOPS means taken per
block then averaged). Under ``torch.distributed`` each rank computes the
loss of its own rows with ``num_blocks`` 1 (``parallel/mesh.py``); with
``global_in_batch_negatives`` its anchors see every rank's positives
(``v33_loss``'s ``mesh``), where the JAX module's shard_map branch
all-gathers them over its ``axis_name``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import torch

from splade_tpu_torch.config.v33 import V33LossConfig
from splade_tpu_torch.parallel.mesh import DataMesh, all_gather_rows

Step = Union[int, torch.Tensor]


class LossMetrics(NamedTuple):
    """Scalars logged per step (reference: losses.py:283-297)."""

    infonce: torch.Tensor
    flops_q: torch.Tensor
    flops_d: torch.Tensor
    flops_neg: torch.Tensor
    lambda_q: torch.Tensor
    lambda_d: torch.Tensor
    lambda_neg: torch.Tensor
    kd: torch.Tensor
    margin_mse: torch.Tensor
    nonzero_q: torch.Tensor
    nonzero_d: torch.Tensor

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return self._asdict()


def flops_loss(sparse_repr: torch.Tensor, num_blocks: int = 1) -> torch.Tensor:
    """FLOPS regularizer (SPLADE-v2 Eq. 4; reference: losses.py:57-73):
    sum_j (mean_i w_ij)^2 over a [N, V] batch; with num_blocks > 1 the mean
    is taken within each contiguous N/num_blocks block and the block losses
    are averaged."""
    x = sparse_repr.to(torch.float32)
    if num_blocks > 1:
        N, V = x.shape
        mean_act = x.reshape(num_blocks, N // num_blocks, V).mean(dim=1)
        return (mean_act * mean_act).sum(dim=-1).mean()
    mean_act = x.mean(dim=0)
    return (mean_act * mean_act).sum()


def lambda_schedule(step: Step, target: float, warmup_steps: int,
                    initial_ratio: float = 0.1,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Quadratic λ warmup with a floor (reference: losses.py:75-90), in f32:

    λ(t) = target · (r0 + (1−r0) · min(1, t/T)²)
    """
    t = torch.as_tensor(step, device=device).to(torch.float32)
    t = torch.clamp(t / max(warmup_steps, 1), max=1.0)
    return (torch.tensor(target, dtype=torch.float32, device=t.device)
            * (initial_ratio + (1.0 - initial_ratio) * t * t))


def _ensure_neg_k(negative: torch.Tensor) -> torch.Tensor:
    """[B, V] -> [B, 1, V]; [B, k, V] unchanged."""
    return negative[:, None, :] if negative.dim() == 2 else negative


def _same_block(B: int, num_blocks: int, device) -> torch.Tensor:
    if B % num_blocks:
        # a remainder would silently form a phantom extra block with a
        # smaller candidate set (and num_blocks > B divides by zero)
        raise ValueError(f"batch {B} not divisible by num_blocks={num_blocks}")
    blk = torch.arange(B, device=device) // (B // num_blocks)
    return blk[:, None] == blk[None, :]


def infonce_loss(anchor: torch.Tensor, positive: torch.Tensor,
                 negative: torch.Tensor, temperature: float = 1.0,
                 num_blocks: int = 1, label_offset: int = 0) -> torch.Tensor:
    """InfoNCE over in-batch positives + explicit hard negatives
    (reference: losses.py:136-181): scores = [q·p_j / τ | q·n_k / τ], label
    = own positive's column, ``label_offset + i`` for anchor i (positive
    may hold more rows than anchor: every rank's, with this rank's at
    ``label_offset``). num_blocks > 1 masks row i's in-batch candidates to
    its contiguous B/num_blocks block (with -inf)."""
    anchor = anchor.to(torch.float32)
    positive = positive.to(torch.float32)
    negative = _ensure_neg_k(negative).to(torch.float32)
    B = anchor.shape[0]
    in_batch = (anchor @ positive.T) / temperature
    if num_blocks > 1:
        in_batch = torch.where(_same_block(B, num_blocks, anchor.device),
                               in_batch, float("-inf"))
    hard = torch.einsum("bv,bkv->bk", anchor, negative) / temperature
    scores = torch.cat([in_batch, hard], dim=1)              # [B, B+k]
    logz = torch.logsumexp(scores, dim=1)
    idx = torch.arange(B, device=anchor.device)
    return (logz - scores[idx, idx + label_offset]).mean()


def margin_mse_loss(anchor: torch.Tensor, positive: torch.Tensor,
                    negative: torch.Tensor, teacher_pos: torch.Tensor,
                    teacher_neg: torch.Tensor) -> torch.Tensor:
    """MarginMSE KD (TAS-B; reference: losses.py:92-134), multi-neg aware."""
    anchor = anchor.to(torch.float32)
    negative = _ensure_neg_k(negative).to(torch.float32)
    teacher_neg = teacher_neg[:, None] if teacher_neg.dim() == 1 else teacher_neg
    s_pos = (anchor * positive.to(torch.float32)).sum(dim=-1)  # [B]
    s_neg = torch.einsum("bv,bkv->bk", anchor, negative)        # [B, k]
    s_margin = s_pos[:, None] - s_neg
    t_margin = (teacher_pos[:, None] - teacher_neg).to(torch.float32)
    return ((s_margin - t_margin) ** 2).mean()


def kl_kd_loss(anchor: torch.Tensor, positive: torch.Tensor,
               teacher_scores: torch.Tensor, kd_temperature: float = 1.0,
               num_blocks: int = 1) -> torch.Tensor:
    """KL KD over the in-batch score matrix (reference: losses.py:239-253):
    KL(teacher softmax || student log-softmax), batchmean. num_blocks > 1
    masks both softmaxes to contiguous blocks, as infonce_loss does."""
    student = (anchor.to(torch.float32) @ positive.to(torch.float32).T
               ) / kd_temperature
    teacher = teacher_scores.to(torch.float32) / kd_temperature
    if num_blocks > 1:
        same = _same_block(student.shape[0], num_blocks, student.device)
        student = torch.where(same, student, float("-inf"))
        teacher = torch.where(same, teacher, float("-inf"))
    t_logp = torch.log_softmax(teacher, dim=-1)
    t_prob = torch.exp(t_logp)
    s_logp = torch.log_softmax(student, dim=-1)
    # -inf - -inf is NaN on masked columns; their probability is 0, so
    # zero the contribution explicitly
    contrib = torch.where(t_prob > 0, t_prob * (t_logp - s_logp), 0.0)
    return contrib.sum(dim=-1).mean()


def v33_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    negative: torch.Tensor,
    step: Step,
    cfg: V33LossConfig,
    teacher_scores: Optional[torch.Tensor] = None,
    teacher_pos_scores: Optional[torch.Tensor] = None,
    teacher_neg_scores: Optional[torch.Tensor] = None,
    num_blocks: int = 1,
    mesh: Optional[DataMesh] = None,
) -> tuple:
    """Full V33 loss (reference: losses.py:183-297) -> (loss, LossMetrics).

    anchor/positive: [B, V]; negative: [B, V] or [B, k, V]; step: the global
    optimizer step for the λ schedule. With cfg.global_in_batch_negatives
    False (reference parity) InfoNCE and KD candidates are per block; FLOPS
    is per block in both modes.

    ``mesh``: this rank's place in a data-parallel run whose gradients are
    summed over ranks and divided by the world size W. With
    global_in_batch_negatives the candidates are every rank's positives in
    rank order (``all_gather_rows``) and anchor i's label is rank·B + i.
    Why that is JAX's gradient: JAX's loss over the global batch is
    L = (1/W) Σ_r L_r, L_r this rank's loss (its anchors' InfoNCE mean over
    all W·B candidates, its own FLOPS block), so ∂L/∂θ = (1/W) Σ_r ∂L_r/∂θ.
    L_r reaches θ through this rank's q and n and through every rank's p.
    The gather's backward all-reduces ∂L_r/∂P over ranks and hands rank r'
    its rows, Σ_r ∂L_r/∂p_r', which rank r' carries into θ through its own
    forward; its gradient is then ∂L_r'/∂θ via q, n plus ∂(Σ_r L_r)/∂θ via
    p_r', and the SUM over r' divided by W is ∂L/∂θ. KD follows the same
    candidates: its teacher scores must then be [B, W·B]."""
    negative = _ensure_neg_k(negative)
    dev = anchor.device
    nce_blocks = 1 if cfg.global_in_batch_negatives else num_blocks
    candidates, offset = positive, 0
    if (cfg.global_in_batch_negatives and mesh is not None
            and mesh.world > 1):
        candidates = all_gather_rows(positive, mesh)
        offset = mesh.rank * anchor.shape[0]
    infonce = infonce_loss(anchor, candidates, negative, cfg.temperature,
                           num_blocks=nce_blocks, label_offset=offset)
    f_q = flops_loss(anchor, num_blocks)
    f_d = flops_loss(positive, num_blocks)
    f_n = flops_loss(negative.reshape(-1, negative.shape[-1]), num_blocks)
    lam_neg_target = cfg.lambda_neg if cfg.lambda_neg > 0 else cfg.lambda_d
    sched = dict(warmup_steps=cfg.flops_warmup_steps,
                 initial_ratio=cfg.lambda_initial_ratio, device=dev)
    lam_q = lambda_schedule(step, cfg.lambda_q, **sched)
    lam_d = lambda_schedule(step, cfg.lambda_d, **sched)
    lam_n = lambda_schedule(step, lam_neg_target, **sched)
    loss = infonce + lam_q * f_q + lam_d * f_d + lam_n * f_n

    kd = torch.zeros((), dtype=torch.float32, device=dev)
    if cfg.lambda_kd > 0 and teacher_scores is not None:
        if teacher_scores.shape[-1] != candidates.shape[0]:
            raise ValueError(
                f"teacher_scores {tuple(teacher_scores.shape)}: KD scores "
                f"each anchor against {candidates.shape[0]} in-batch "
                "candidates (every rank's positives under "
                "global_in_batch_negatives)")
        kd = kl_kd_loss(anchor, candidates, teacher_scores,
                        cfg.kd_temperature, num_blocks=nce_blocks)
        loss = loss + cfg.lambda_kd * kd
    mmse = torch.zeros((), dtype=torch.float32, device=dev)
    if (cfg.lambda_margin_mse > 0 and teacher_pos_scores is not None
            and teacher_neg_scores is not None):
        mmse = margin_mse_loss(anchor, positive, negative,
                               teacher_pos_scores, teacher_neg_scores)
        loss = loss + cfg.lambda_margin_mse * mmse

    with torch.no_grad():
        nonzero_q = (anchor > 0).to(torch.float32).sum(dim=-1).mean()
        nonzero_d = (positive > 0).to(torch.float32).sum(dim=-1).mean()
    metrics = LossMetrics(
        infonce=infonce, flops_q=f_q, flops_d=f_d, flops_neg=f_n,
        lambda_q=lam_q, lambda_d=lam_d, lambda_neg=lam_n,
        kd=kd, margin_mse=mmse, nonzero_q=nonzero_q, nonzero_d=nonzero_d,
    )
    return loss, metrics
