"""The exact rescore kernel at the served shape, on the card, over the number
of candidates a lane group takes.

    python scripts/bench_rescore.py

Builds copies of ``splade_tpu_torch/csrc/rescore.cu`` with ``PER`` (the
candidates each 8-lane group takes, whose rows it loads together) set to 1,
2 and 4, editing the source text at one anchor (it stops if the anchor
moved), each into a library of its own under ``build/bench_rescore/``. At
B=32 C=1000 M=64 T=64 over ``chip_smoke.py``'s 1M-document Zipf corpus,
quantized to the doc-major int8 block as its ``check_rescore`` does, it
times each variant (a CUDA graph of 200 launches, ``chip_smoke.graph_ms``:
launched one by one from Python, a call takes longer on the host than the
kernel on the card) in one order and then the reverse, on two
queries: uniform random term ids, and ``check_rescore``'s kind, whose last
32 slots take the candidates' own (small, frequent) ids; every output is
checked against ``rescore_match_plain`` within 1e-4. Each variant is timed
again with M = 0, which reads no document row: the launch, the candidate
ids and scales and the table's build alone. Prints the card's name and
power limit first (about a minute).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from splade_tpu_torch.ops import _cuda  # noqa: E402
from splade_tpu_torch.ops.rescore_kernel import rescore_match_plain  # noqa: E402

ANCHOR = "constexpr int PER = 1;"
PERS = (1, 2, 4)
B, C, M, T = 32, 1000, 64, 64


def build(pers) -> dict:
    """PER -> the loaded library of rescore.cu with that PER."""
    text = (_cuda.CSRC / "rescore.cu").read_text()
    if text.count(ANCHOR) != 1:
        raise SystemExit(f"bench_rescore: anchor {ANCHOR!r} moved")
    out = _cuda.BUILD_DIR.parent / "bench_rescore"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for per in pers:
        src = out / f"rescore_per{per}.cu"
        src.write_text(text.replace(ANCHOR, f"constexpr int PER = {per};"))
        procs[per] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.CFLAGS, "-shared",
             str(src), "-o", str(out / f"librescore_per{per}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for per, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bench_rescore: nvcc failed for PER={per}:\n"
                             f"{log}")
        lib = ctypes.CDLL(str(out / f"librescore_per{per}.so"))
        lib.splade_rescore_match.argtypes = _cuda.SIGNATURES[
            "splade_rescore_match"]
        lib.splade_rescore_match.restype = ctypes.c_int
        libs[per] = lib
    return libs


def inputs(rng):
    """The doc-major block, the candidates and the two queries."""
    terms, vals = cs.zipf_corpus_csr(rng, cs.POSTINGS_DOCS)
    N, nnz = terms.shape
    d_terms = np.full((N, M), cs.V, np.int32)
    d_terms[:, :nnz] = terms
    scale = (vals.max(1) / 127.0).astype(np.float32)
    d_vals = np.zeros((N, M), np.int8)
    d_vals[:, :nnz] = np.clip(np.round(vals / scale[:, None]), -127, 127)
    cand = rng.integers(0, N, (B, C))
    q_val = rng.uniform(0.1, 2.0, (B, T)).astype(np.float32)
    random_ids = rng.integers(0, cs.V, (B, T)).astype(np.int32)
    planted = random_ids.copy()
    planted[:, T - 32:] = d_terms[cand[:, :32], np.arange(32)]
    dev = lambda x: torch.from_numpy(x).cuda()
    block = (dev(d_terms), dev(d_vals), dev(scale))
    return block, dev(cand.astype(np.int32)), dev(q_val), {
        "random ids": dev(random_ids), "planted small ids": dev(planted)}


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_rescore: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    libs = build(PERS)
    (d_terms, d_vals, d_scale), cand, q_val, queries = inputs(
        np.random.default_rng(0))
    N = d_terms.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device="cuda")

    def launch(per, q_idx, m=M):
        _cuda.check(libs[per].splade_rescore_match(
            d_terms.data_ptr(), d_vals.data_ptr(), d_scale.data_ptr(),
            q_idx.data_ptr(), q_val.data_ptr(), cand.data_ptr(),
            out.data_ptr(), N, B, C, m, T,
            torch.cuda.current_stream().cuda_stream), "splade_rescore_match")

    # the card's clocks up before the first timing
    cs.cuda_ms(torch, lambda: launch(PERS[0], queries["random ids"]),
               iters=5000)
    for name, q_idx in queries.items():
        ref = rescore_match_plain(d_terms, d_vals, d_scale, q_idx, q_val,
                                  cand)
        times = {per: [] for per in PERS}
        no_rows = {}
        for order in (PERS, PERS[::-1]):
            for per in order:
                times[per].append(cs.graph_ms(
                    torch, lambda: launch(per, q_idx), iters=200))
                err = float((out - ref).abs().max())
                if not err <= cs.RESCORE_TOL:
                    raise SystemExit(f"PER={per} {name}: max |err| {err}")
                no_rows[per] = cs.graph_ms(
                    torch, lambda: launch(per, q_idx, 0), iters=200)
        print(f"{name}: " + ", ".join(
            f"PER={per} {t[0]:.5f} / {t[1]:.5f} ms (M = 0: "
            f"{no_rows[per]:.5f})" for per, t in times.items())
            + " (one order / the reverse)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
