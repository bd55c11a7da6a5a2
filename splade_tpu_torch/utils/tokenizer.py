"""Tokenizer resolution for the 50K-vocab Korean ModernBERT checkpoint.

Counterpart of ``splade_tpu/utils/tokenizer.py``. Resolution order:

1. an explicit local path argument,
2. ``$SPLADE_TOKENIZER_PATH``,
3. the HF name (local cache only: there is no network),
4. the repo-relative ``assets/tokenizer`` artifact.

``transformers`` is imported inside ``create_tokenizer`` only, so the
package imports on a machine without it.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

_FALLBACK_DIRS = ("assets/tokenizer",)


def resolve_tokenizer_path(name_or_path: Optional[str] = None) -> str:
    if name_or_path and Path(name_or_path).exists():
        return name_or_path
    env = os.environ.get("SPLADE_TOKENIZER_PATH")
    if env and Path(env).exists():
        return env
    # an explicitly requested HF name resolves via the offline cache, before
    # the fallback dirs, so a local artifact never shadows it
    if name_or_path:
        return name_or_path
    for d in _FALLBACK_DIRS:
        if Path(d).exists():
            return d
    return "skt/A.X-Encoder-base"


def create_tokenizer(name_or_path: Optional[str] = None):
    """Load the HF fast tokenizer. The fallback dirs are a last resort,
    taken with a warning when the requested name fails to load."""
    from transformers import AutoTokenizer

    path = resolve_tokenizer_path(name_or_path)
    try:
        return AutoTokenizer.from_pretrained(path)
    except (OSError, ValueError) as e:
        for d in _FALLBACK_DIRS:
            if Path(d).exists() and str(Path(d)) != str(path):
                logging.getLogger(__name__).warning(
                    "tokenizer %r unavailable (%s); falling back to %s",
                    path, e, d)
                return AutoTokenizer.from_pretrained(d)
        raise
