"""The optimizer step of both recipes, float32: the accumulated gradient
divided by the micro-batch count, clipped to a global norm, then AdamW
(betas 0.9 / 0.999, eps 1e-8, decoupled weight decay, none on norm weights
and biases) at a warm-up-cosine learning rate read at the count of
updates already made (so the first update has rate 0), as
``optax.warmup_cosine_decay_schedule`` gives it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def warmup_cosine(peak: float, total_steps: int, warmup_ratio: float
                  ) -> Callable[[int], float]:
    warmup = max(int(total_steps * warmup_ratio), 1)
    decay = max(total_steps, warmup + 1) - warmup

    def lr(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        count = min(step - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * count / decay))

    return lr


def decays(name: str) -> bool:
    return not (name.endswith("bias") or name.endswith("norm.weight"))


class Reference:
    """Parameters (leaves with ``.grad``) and AdamW state of the
    reference. ``leaves`` are the trained names: the tied decoder weight is
    the embedding's leaf."""

    def __init__(self, weights: Dict[str, torch.Tensor], lr: Callable,
                 weight_decay: float, clip: float):
        self.p = {n: w.detach().float().clone().requires_grad_(True)
                  for n, w in weights.items() if n != "decoder.weight"}
        self.leaves: List[str] = list(self.p)
        self.p["decoder.weight"] = self.p[
            "model.embeddings.tok_embeddings.weight"]
        self.m = {n: torch.zeros_like(self.p[n]) for n in self.leaves}
        self.v = {n: torch.zeros_like(self.p[n]) for n in self.leaves}
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.step = 0

    def grads(self) -> Dict[str, torch.Tensor]:
        return {n: self.p[n].grad for n in self.leaves}

    @torch.no_grad()
    def apply(self, accum: int) -> Dict[str, torch.Tensor]:
        """One optimizer step from the summed gradients; returns the
        gradient as the optimizer got it (averaged and clipped)."""
        g = {n: (self.p[n].grad if self.p[n].grad is not None
                 else torch.zeros_like(self.p[n])) / accum
             for n in self.leaves}
        total = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
        scale = min(1.0, self.clip / (float(total) + 1e-6))
        lr = self.lr(self.step)
        self.step += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        for n in self.leaves:
            gn = g[n] * scale
            g[n] = gn
            self.m[n].mul_(b1).add_(gn, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(gn, gn, value=1 - b2)
            w = self.p[n]
            if decays(n):
                w.mul_(1 - lr * self.wd)
            denom = (self.v[n].sqrt() / math.sqrt(c2)).add_(EPS)
            w.addcdiv_(self.m[n], denom, value=-lr / c1)
            w.grad = None
        return g
