"""The port's device rule.

Entry points run on ``cuda`` unless the caller asks for the CPU. With no
card and no explicit device they raise: they never carry on on the CPU.
A process that torchrun started (``LOCAL_RANK`` set) runs on
``cuda:{LOCAL_RANK}`` when it asks for no device or for ``cuda`` without an
index, so the ranks of one host do not share a card.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``, and ``cuda`` -> ``cuda:{LOCAL_RANK}`` under
    torchrun; a CUDA device must exist, else RuntimeError. Any other
    explicit device (``cpu``, ``cuda:1``) is taken as it is."""
    dev = torch.device("cuda" if device is None else device)
    local_rank = os.environ.get("LOCAL_RANK")
    if dev.type == "cuda" and dev.index is None and local_rank is not None:
        dev = torch.device("cuda", int(local_rank))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: splade_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev

