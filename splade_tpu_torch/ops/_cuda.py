"""Builder and loader of the port's hand-written Hopper kernels.

At first use, every ``splade_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
(one process per source, all started together) for ``sm_90a`` and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library lives under ``build/splade_tpu_torch/`` at the repo
root, named by a hash of the flags, the sources and the headers they
include (``csrc/*.cuh``), so an edited source or header is rebuilt and an
unchanged one is reused. Processes that start together (the ranks of a
data-parallel run) build once: the build holds an exclusive ``flock`` on
``build.lock`` in that directory, and a process that waited for it finds the
library made. PyTorch's headers are never
included: a build takes seconds, not the minutes of
``torch.utils.cpp_extension.load``.

Each launching C entry returns ``cudaGetLastError()``; :func:`check` raises
on a non-zero code. A failed build raises too: nothing falls back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "splade_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: what the splash attention entries take after their pointers: the strides of
#: q, k and v (batch row, head, position), B, N, S, D, half_window, scale, stream
_SPLASH_TAIL = [_L] * 9 + [_I] * 5 + [_F, _P]
#: C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES: Dict[str, List] = {
    "splade_fused_pool_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the same launch with its blocks in the other order (measurement only)
    "splade_fused_pool_fwd_batch_first": [_P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _P],
    # ... B, S, H, V, hidden slices, vocab splits, stream
    "splade_fused_pool_bwd_dh": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _P],
    "splade_fused_pool_bwd_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "splade_rescore_match": [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
    "splade_fused_pool_v2_fwd": [_P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
    # ... B, S, H, V, the row block, stream
    "splade_fused_pool_v2_bwd_match": [_P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _P],
    # (S, RB) -> bytes of dynamic shared memory, not an error
    # code
    "splade_fused_pool_v2_fwd_shared_bytes": [_I, _I],
    "splade_fused_pool_v2_bwd_shared_bytes": [_I, _I],
    # () -> bytes of the kernel's static shared memory, -1 if unknown
    "splade_fused_pool_v2_fwd_static_bytes": [],
    "splade_fused_pool_v2_bwd_static_bytes": [],
    "splade_splash_attn_fwd": [_P] * 6 + _SPLASH_TAIL,
    # the pointers, then whether each gradient is written in bf16 (else f32)
    "splade_splash_attn_bwd_dq": [_P] * 9 + [_I] + _SPLASH_TAIL,
    "splade_splash_attn_bwd_dkv": [_P] * 9 + [_I, _I] + _SPLASH_TAIL,
    # qkv, cos, sin, out, then B, S, N, D, the tables' batch stride, stream
    "splade_rope_qkv_fwd": [_P] * 4 + [_I] * 4 + [_L, _P],
    # dq, dk, dv, cos, sin, dqkv, the strides of dq, dk and dv (batch row,
    # position, head), then B, S, N, D, the tables' batch stride, stream
    "splade_rope_qkv_bwd": [_P] * 6 + [_L] * 9 + [_I] * 4 + [_L, _P],
    # r, b, gamma, r_out, n, stats, then rows, H, rows a block, eps,
    # whether n is bf16 (else f32), stream
    "splade_add_layernorm_fwd": [_P] * 6 + [_L, _I, _I, _F, _I, _P],
    # dn, r', stats, gamma, d_above, dr, db, partial, dgamma, then rows, H,
    # rows a block, whether dn is bf16 (else f32), stream
    "splade_add_layernorm_bwd": [_P] * 9 + [_L, _I, _I, _I, _P],
}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


class _Library:
    """The built library and its ptxas report, made once per process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self.lib is None:
                path, self.build_log = build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self.lib = lib
            return self.lib


_LIBRARY = _Library()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build_tag() -> str:
    """Hash of the flags, the sources and the headers: the library's name."""
    digest = hashlib.sha256()
    for flag in ARCH_FLAGS + CFLAGS:
        digest.update(flag.encode())
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def build() -> tuple:
    """Compile and link the kernels if the hashed library is absent.
    Returns (library path, compiler log)."""
    out = BUILD_DIR / f"libsplade_kernels_{build_tag()}.so"
    log_path = out.with_suffix(".log")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # the lock is the open file's: released when it closes or the
        # process dies, so a killed build leaves nothing that blocks
        with open(BUILD_DIR / "build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not out.exists():  # else another process built it meanwhile
                return _compile_and_link(out, log_path)
    return out, log_path.read_text() if log_path.exists() else ""


def _compile_and_link(out: Path, log_path: Path) -> tuple:
    srcs = sources()
    tag = out.stem[len("libsplade_kernels_"):]
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    logs = []
    failed = []
    for src, proc in zip(srcs, procs):
        text, _ = proc.communicate()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return _LIBRARY.get()


def build_log() -> str:
    """ptxas report of the build (registers, shared memory, spills)."""
    library()
    return _LIBRARY.build_log


def check(code: int, name: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{name}: CUDA error {code} at launch")


def stream_ptr(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
