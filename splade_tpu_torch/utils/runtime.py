"""The port's device rule.

Entry points run on ``cuda`` unless the caller asks for the CPU. With no
card and no explicit device they raise: they never carry on on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist, else RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: splade_tpu_torch runs on the GPU unless the "
            "caller passes device='cpu'")
    return dev

