"""Model FLOPs of the ModernBERT encoder and its heads, from the lengths
of the rows a call carried: the work a forward pass needs, counted at the
valid tokens only (padding is not work), 2 operations a multiply-add.

A layer: the QKV, output and GeGLU projections, 2 (4 H^2 + 3 H I) a token;
attention, 4 H a (query, key) pair the mask allows (QK^T and PV), with a
global layer's pairs the row's length squared and a local layer's those
within the half window. The MLM head's dense layer 2 H^2 and the
vocabulary projection 2 H V a token it is applied to (every valid token for
the SPLADE pool, the masked positions for MLM). A training step needs
three forward passes' worth (the backward twice the forward), whatever
remat recomputes.
"""

from __future__ import annotations

import numpy as np


def local_pairs(L: np.ndarray, half: int) -> np.ndarray:
    """Pairs (i, j), |i - j| <= half, in rows of L valid tokens."""
    L = np.asarray(L, np.float64)
    w = np.minimum(L - 1, half)
    # each i sees itself and min(i, half) before and min(L-1-i, half) after
    return L + 2 * (w * L - w * (w + 1) / 2)


def forward_flops(cfg: dict, lengths, projected=None) -> float:
    """Forward FLOPs of rows of ``lengths`` valid tokens; ``projected``:
    the tokens the vocabulary projection runs on (default: all valid)."""
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    n_layers = cfg["num_hidden_layers"]
    every = cfg["global_attn_every_n_layers"]
    n_global = len(range(0, n_layers, every))
    L = np.asarray(lengths, np.float64).reshape(-1)
    L = L[L > 0]
    tokens = L.sum()
    dense = n_layers * 2 * (4 * H * H + 3 * H * I) * tokens
    attn = 4 * H * (n_global * (L * L).sum() + (n_layers - n_global)
                    * local_pairs(L, cfg["local_attention"] // 2).sum())
    proj = tokens if projected is None else projected
    head = 2 * H * H * proj + 2 * H * V * proj
    return float(dense + attn + head)
