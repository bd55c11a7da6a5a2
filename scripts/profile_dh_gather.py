"""Where the pool backward's dh gather spends its time, on the card.

    python scripts/profile_dh_gather.py

Builds an instrumented copy of the dh gather from
``splade_tpu_torch/csrc/fused_splade_bwd.cu`` (clock64 stamps around its
phases; the arithmetic is the kernel's own) into ``build/profile_dh_gather/``
and runs it on the bitmask of the per-row family's match pass (the shared
one, at ``routed_row_block``) at the training shapes (documents B=128
S=256, queries B=64 S=64), a ragged length (B=8 S=200) and an odd batch
(B=3 S=40, row_block 1); H=768, V=50,000; model-like random inputs, a fully
padded row. Each shape runs at (hidden slices, vocab ranges) (1, 1), (3, 1)
and the rule both families take (``dh_splits``). Thread 0 of every block
records the cycles of its whole run and of three phases: the scan and
compaction of each chunk's mask words into the list, the wait for a batch's
first W row, and the adds into the shared-memory sums. Prints the card, the
per-block means and the cycles per listed match, and checks the
instrumented kernel's dh (its ranges' partials added in order) against the
plain gather.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from splade_tpu_torch.ops import _cuda  # noqa: E402
from splade_tpu_torch.ops import fused_splade as fs  # noqa: E402

SHAPES = ((128, 256), (64, 64), (8, 200), (3, 40))
H, V = 768, 50_000


def instrumented_source() -> str:
    """The dh gather section of the backward source with clock stamps, and
    a C entry that launches it with a [blocks, 6] int64 record buffer."""
    src = (_cuda.CSRC / "fused_splade_bwd.cu").read_text()
    head = src[:src.index("namespace {")]
    body = src[src.index("// ---- the dh gather"):
               src.index("// ---- the dW gather")]
    edits = [
        ("int S, int H, int V, int J, int slice, int range) {",
         "int S, int H, int V, int J, int slice, int range, "
         "long long* prof) {\n"
         "  long long t_scan = 0, t_wait = 0, t_add = 0, n_ent = 0;\n"
         "  const long long t0 = clock64();"),
        ("  for (int v0 = vb; v0 < ve; v0 += DH_CW * T) {\n",
         "  for (int v0 = vb; v0 < ve; v0 += DH_CW * T) {\n"
         "    const long long ta = clock64();\n"),
        ("    __syncthreads();  // the list is complete\n",
         "    __syncthreads();  // the list is complete\n"
         "    t_scan += clock64() - ta;\n    n_ent += n;\n"),
        ("        dh_apply(t, acc_s, width, c);\n",
         "        const long long tb = clock64();\n"
         "        if (__bfloat162float(reinterpret_cast<const __nv_bfloat162*>"
         "(&t.raw[0])[0].x) == 12345.f)\n"
         "          acc_s[0] = 1.f;  // waits for the batch's first row\n"
         "        const long long tc = clock64();\n"
         "        t_wait += tc - tb;\n"
         "        dh_apply(t, acc_s, width, c);\n"
         "        t_add += clock64() - tc;\n"),
        ("  __syncthreads();  // the sums are complete",
         "  if (threadIdx.x == 0) {\n"
         "    long long* o = prof + (((size_t)blockIdx.z * gridDim.y + "
         "blockIdx.y) * gridDim.x + blockIdx.x) * 6;\n"
         "    o[0] = clock64() - t0; o[1] = t_scan; o[2] = t_wait;\n"
         "    o[3] = t_add; o[4] = n_ent; o[5] = 0;\n  }\n"
         "  __syncthreads();  // the sums are complete"),
    ]
    for old, new in edits:
        if body.count(old) != 1:
            raise SystemExit(f"the dh gather no longer has {old[:50]!r}: "
                             "update the instrumentation")
        body = body.replace(old, new)
    entry = '''
}  // namespace
extern "C" int profile_dh(const void* match, const void* w, const void* g,
                          void* dh, int B, int S, int H, int V, int splits,
                          int vocab_splits, void* prof, void* stream) {
  const int groups = (H + DH_WARP_COLS - 1) / DH_WARP_COLS;
  const int slice = (groups + splits - 1) / splits * DH_WARP_COLS;
  const int width = slice < H ? slice : H;
  const int threads = (width / DH_COLS + 31) / 32 * 32;
  const int bytes = 32 * width * 4;
  cudaFuncSetAttribute((const void*)fused_splade_bwd_dh_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const int J = (S + 31) / 32;
  const int range = ((V + 31) / 32 + vocab_splits - 1) / vocab_splits * 32;
  dim3 grid(B * J, (H + slice - 1) / slice, vocab_splits);
  fused_splade_bwd_dh_kernel<<<grid, threads, bytes, (cudaStream_t)stream>>>(
      (const uint32_t*)match, (const __nv_bfloat16*)w, (const float*)g,
      (float*)dh, S, H, V, J, slice, range, (long long*)prof);
  return (int)cudaGetLastError();
}
'''
    return head + "namespace {\nconstexpr int MAX_H = 768;\n" + body + entry


def build() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR.parent / "profile_dh_gather"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "dh_gather_profiled.cu"
    src.write_text(instrumented_source())
    lib = out / "libdh_gather_profiled.so"
    subprocess.run([_cuda._nvcc(), *_cuda.ARCH_FLAGS, *_cuda.CFLAGS,
                    "-shared", str(src), "-o", str(lib)], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.profile_dh.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P]
    dll.profile_dh.restype = ctypes.c_int
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_dh_gather: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    dll = build()
    for B, S in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(B * S)
        h = torch.randn(B, S, H, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(V, H, device="cuda", generator=gen) * 0.05).bfloat16()
        bias = torch.randn(V, device="cuda", generator=gen) * 0.1
        lens = torch.randint(1, S + 1, (B,), device="cuda", generator=gen)
        lens[-1] = 0
        mask = (torch.arange(S, device="cuda")[None] < lens[:, None]).float()
        m, _ = fs.fused_splade_maxima(h, w, bias, mask)
        g_pre = fs.fold_cotangent(
            torch.randn(B, V, device="cuda", generator=gen), m)
        match = fs.fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
        want = fs.fused_splade_gather_dh_plain(match, w, g_pre, S)
        for splits, vocab in dict.fromkeys(
                ((1, 1), (3, 1), fs.dh_splits(B, S, H, V))):
            dh = torch.empty(vocab, B, S, H, device="cuda")
            width = -(-(-(-H // 128)) // splits) * 128  # the C entry's slice
            slices = -(-H // width)
            prof = torch.zeros(vocab * B * fs.match_words(S) * slices, 6,
                               dtype=torch.int64, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            run = lambda: _cuda.check(dll.profile_dh(
                match.data_ptr(), w.data_ptr(), g_pre.data_ptr(),
                dh.data_ptr(), B, S, H, V, splits, vocab, prof.data_ptr(),
                stream), "profile_dh")
            run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            got = fs.add_partials(dh.clone())
            err = float((got - want).abs().max() / want.abs().max())
            total, scan, wait, add, n = prof.double().mean(0).tolist()[:5]
            n = max(n, 1.0)
            print(f"B={B} S={S} hidden slices {splits}, vocab ranges "
                  f"{vocab}: {start.elapsed_time(end):.3f} ms "
                  f"(instrumented), dh vs plain {err:.2e}; per block "
                  f"{total:.0f} cycles over {n:.0f} listed matches: scan and "
                  f"list {scan / total:.1%}, W wait {wait / total:.1%}, adds "
                  f"{add / total:.1%}; cycles a match: scan {scan / n:.1f}, "
                  f"wait {wait / n:.1f}, adds {add / n:.1f}")
            if not err <= 1e-5:
                raise SystemExit("the instrumented dh gather disagrees")
    return 0


if __name__ == "__main__":
    sys.exit(main())
