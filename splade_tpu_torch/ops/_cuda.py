"""Builder and loader of the port's hand-written Hopper kernels.

At first use, every ``splade_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
(one process per source, all started together) for ``sm_90a`` and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``. The library lives under ``build/splade_tpu_torch/`` at the repo
root, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. PyTorch's headers are never
included: a build takes seconds, not the minutes of
``torch.utils.cpp_extension.load``.

Each C entry returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. A failed build raises too: nothing falls back.
"""

from __future__ import annotations

import ctypes
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
#: C signature of every entry point: name -> argtypes (restype is int)
SIGNATURES: Dict[str, List] = {
    "splade_fused_pool_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "splade_rescore_match": [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
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


def build() -> tuple:
    """Compile and link the kernels if the hashed library is absent.
    Returns (library path, compiler log)."""
    srcs = sources()
    digest = hashlib.sha256()
    for flag in ARCH_FLAGS + CFLAGS:
        digest.update(flag.encode())
    for src in srcs:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"libsplade_kernels_{tag}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
