"""The masked-LM loss of one micro-batch, float32: the encoder over the
corrupted rows (the padding of the
original rows masked), the MLM head and the tied projection at
the selected positions, cross-entropy against the original tokens,
weighted, summed and divided by the micro-batch's count of weighted
positions (plus 1e-6)."""

from __future__ import annotations

from typing import Sequence

import torch

from perfbench.reference import modernbert as mb

ROWS = 8  # rows a block: a block's graph fits the card in float32


def mlm_micro_grads(p, cfg: dict, micro: dict, pad_id: int, mm=mb.f32_mm,
                    keep: Sequence[int] = ()) -> float:
    """Loss of one micro-batch {corrupted, pos, labels, weights}; its
    gradient is added to each leaf's ``.grad``, a block of rows at a time
    (the loss is a sum over rows over a count fixed beforehand)."""
    cor, pos = micro["corrupted"].long(), micro["pos"].long()
    labels, w = micro["labels"].long(), micro["weights"].float()
    valid = (micro["ids"] != pad_id).long()
    if len(keep):
        sel = torch.as_tensor(list(keep), device=cor.device)
        cor, pos, labels, w, valid = (cor[sel], pos[sel], labels[sel],
                                      w[sel], valid[sel])
    denom = w.sum() + 1e-6
    total = 0.0
    for i in range(0, cor.shape[0], ROWS):
        hidden = mb.encode(p, cfg, cor[i:i + ROWS], valid[i:i + ROWS], mm=mm)
        sel = torch.gather(hidden, 1, pos[i:i + ROWS, :, None].expand(
            -1, -1, hidden.shape[-1]))
        logits = mb.vocab_logits(p, mb.head(p, cfg, sel, mm), mm)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.gather(logp, 2, labels[i:i + ROWS, :, None])[..., 0]
        loss = (ce * w[i:i + ROWS]).sum() / denom
        loss.backward()
        total += float(loss.detach())
    return total
