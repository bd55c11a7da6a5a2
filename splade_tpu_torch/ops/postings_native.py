"""ctypes bridge to the C++ parallel postings builder.

Counterpart (a copy) of ``splade_tpu/ops/postings_native.py``.
``tools/postings_build/`` implements invert_to_postings' output contract
natively (counting bucket-by-term + per-term top-P selection,
multithreaded); the numpy packed-uint64 sort it replaces needs minutes for
a 10M-doc corpus on one core.

Resolution: $SPLADE_POSTINGS_LIB, the repo-relative build, or None (callers
use the numpy build: the library is an accelerator of host code, never a
requirement).
"""

from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_DEFAULT_LIB = str(Path(__file__).resolve().parents[2]
                   / "tools" / "postings_build" / "libpostings_build.so")
_lib = None
_warned_missing_env = False
_unusable: set = set()  # candidates whose dlopen failed (warned once each)


def load_library() -> Optional[ctypes.CDLL]:
    # Memoize only SUCCESS: a missing .so at first call must not
    # permanently disable the native path — the library may be built
    # later in the same process (observed: the test fixture runs `make`
    # after an earlier test already probed and cached None). Re-scanning
    # on failure costs a couple of stat() calls per call, nothing next
    # to the work the library saves. The candidate list is rebuilt from
    # the CURRENT environment so a late-set $SPLADE_POSTINGS_LIB wins
    # over the repo default (ADVICE r3). dlopen failures ARE memoized
    # per candidate: a wrong-arch .so won't load on retry either, and
    # re-warning every call spams loops that build postings repeatedly.
    global _lib, _warned_missing_env
    if _lib is not None:
        return _lib
    env_path = os.environ.get("SPLADE_POSTINGS_LIB")
    if env_path and not Path(env_path).exists() and not _warned_missing_env:
        # an explicit override must not silently fall through to the
        # repo-default .so (operator expects THEIR freshly-built library)
        logger.warning("SPLADE_POSTINGS_LIB=%s does not exist; falling "
                       "back to the default library search", env_path)
        _warned_missing_env = True
    for cand in (env_path or "", _DEFAULT_LIB):
        if not cand or cand in _unusable or not Path(cand).exists():
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError as e:  # wrong arch / missing deps
            logger.warning("postings native lib %s unusable: %s", cand, e)
            _unusable.add(cand)
            continue
        lib.build_postings.restype = ctypes.c_int64
        lib.build_postings.argtypes = [
            ctypes.POINTER(ctypes.c_int32),   # terms
            ctypes.POINTER(ctypes.c_float),   # vals
            ctypes.POINTER(ctypes.c_int32),   # doc_of
            ctypes.c_int64,                   # nnz
            ctypes.c_int32,                   # vocab
            ctypes.c_int32,                   # P
            ctypes.POINTER(ctypes.c_int32),   # post_docs out
            ctypes.POINTER(ctypes.c_float),   # post_w out
            ctypes.c_int32,                   # n_threads (0 = auto)
        ]
        _lib = lib
        break
    return _lib


def build_postings_native(
    all_terms: np.ndarray, all_vals: np.ndarray, all_docs: np.ndarray,
    vocab_size: int, n_postings: int, n_threads: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Native invert-to-postings; None when the library is unavailable."""
    lib = load_library()
    if lib is None:
        return None
    terms = np.ascontiguousarray(all_terms, np.int32)
    vals = np.ascontiguousarray(all_vals, np.float32)
    docs = np.ascontiguousarray(all_docs, np.int32)
    post_docs = np.zeros((vocab_size, n_postings), np.int32)
    post_w = np.zeros((vocab_size, n_postings), np.float32)
    truncated = lib.build_postings(
        terms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(terms), vocab_size, n_postings,
        post_docs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        post_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    if truncated < 0:
        logger.warning("native postings build rejected arguments; "
                       "falling back to numpy")
        return None
    return post_docs, post_w, int(truncated)
