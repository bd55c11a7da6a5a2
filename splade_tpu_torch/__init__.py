"""splade_tpu_torch — the PyTorch/CUDA port of ``splade_tpu`` for NVIDIA H100.

Mirrors ``splade_tpu``'s module layout (``splade_tpu/X/y.py`` has its
counterpart at ``splade_tpu_torch/X/y.py``) and is held numerically against
it by the ``tests/test_torch_*.py`` parity tests. It imports ``torch`` and
never ``jax`` or ``splade_tpu``. Every Pallas kernel of the reference on a
ported path is a hand-written Hopper kernel under ``csrc/``, built at first
use by ``ops/_cuda.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit device they raise (``utils/runtime.py``).
"""

__version__ = "0.1.0"
