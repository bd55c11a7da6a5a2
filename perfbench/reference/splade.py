"""Plain SPLADE-max encoding and the V33 loss, float32.

    rep[b, v] = log1p(relu(max over valid positions s of logits[b, s, v]))

with the logits of the MLM head over the whole vocabulary. The V33 loss
(the reference recipe's SPLADELossV33 without distillation): InfoNCE over
in-batch positives and the hard negatives, temperature 1, plus FLOPS
regularisers sum_v (mean_b rep[b, v])^2 for queries, positives and
negatives, weighted by lambda(t) = target * (r0 + (1 - r0) min(1, t/T)^2).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from perfbench.reference import modernbert as mb

ROWS = 16  # rows a block: the [rows, S, V] logits of one block fit the card


def pool(p: Dict[str, torch.Tensor], cfg: dict, ids, mask, mm=mb.f32_mm
         ) -> torch.Tensor:
    """[B, S] -> [B, V] SPLADE-max vectors of one block of rows."""
    t = mb.head(p, cfg, mb.encode(p, cfg, ids, mask, mm=mm), mm)
    logits = mb.vocab_logits(p, t, mm)
    logits = logits.masked_fill(~mask.bool()[:, :, None], mb.MASK_NEG)
    return torch.log1p(torch.relu(logits.amax(dim=1)))


def encode_rows(p, cfg, ids, mask, mm=mb.f32_mm, rows: int = ROWS
                ) -> torch.Tensor:
    """``pool`` over all rows, a block at a time."""
    return torch.cat([pool(p, cfg, ids[i:i + rows], mask[i:i + rows], mm)
                      for i in range(0, ids.shape[0], rows)])


def lambda_at(step: int, target: float, warmup: int, r0: float) -> float:
    t = min(step / max(warmup, 1), 1.0)
    return target * (r0 + (1.0 - r0) * t * t)


def flops(rep: torch.Tensor) -> torch.Tensor:
    mean = rep.mean(dim=0)
    return (mean * mean).sum()


def v33_loss(q, d_pos, d_neg, step: int, loss_cfg: dict) -> torch.Tensor:
    """q, d_pos, d_neg [B, V] -> the scalar loss at optimizer step ``step``
    (the count of updates already made)."""
    B = q.shape[0]
    scores = torch.cat([q @ d_pos.t(), (q * d_neg).sum(-1, keepdim=True)],
                       dim=1) / loss_cfg["temperature"]
    idx = torch.arange(B, device=q.device)
    infonce = (torch.logsumexp(scores, dim=1) - scores[idx, idx]).mean()
    sched = (loss_cfg["flops_warmup_steps"], loss_cfg["lambda_initial_ratio"])
    lam_d = loss_cfg["lambda_d"]
    lam_n = loss_cfg.get("lambda_neg", 0.0) or lam_d
    return (infonce + lambda_at(step, loss_cfg["lambda_q"], *sched) * flops(q)
            + lambda_at(step, lam_d, *sched) * flops(d_pos)
            + lambda_at(step, lam_n, *sched) * flops(d_neg))


def v33_micro_grads(p: Dict[str, torch.Tensor], cfg: dict, micro: dict,
                    step: int, loss_cfg: dict, mm=mb.f32_mm,
                    keep: Sequence[int] = ()) -> float:
    """Loss of one micro-batch; its gradient is added to each leaf's
    ``.grad``. The loss couples every row, so the vectors are made first
    without a graph, the loss's gradient against them taken, and each
    block of rows then run again with a graph and given its share.
    ``keep``: the rows the loss is taken over (all when empty)."""
    names = ("query", "positive", "negative")
    sel = (torch.as_tensor(list(keep), device=micro["query_ids"].device)
           if len(keep) else None)
    parts = {}
    for n in names:
        ids, mask = micro[n + "_ids"], micro[n + "_mask"]
        if sel is not None:
            ids, mask = ids[sel], mask[sel]
        parts[n] = (ids, mask)
    with torch.no_grad():
        reps = {n: encode_rows(p, cfg, *parts[n], mm) for n in names}
    leaves = {n: r.clone().requires_grad_(True) for n, r in reps.items()}
    loss = v33_loss(leaves["query"], leaves["positive"], leaves["negative"],
                    step, loss_cfg)
    loss.backward()
    for n in names:
        ids, mask = parts[n]
        g = leaves[n].grad
        for i in range(0, ids.shape[0], ROWS):
            out = pool(p, cfg, ids[i:i + ROWS], mask[i:i + ROWS], mm)
            out.backward(g[i:i + ROWS])
    return float(loss.detach())
