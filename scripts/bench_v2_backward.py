"""The pool backward's kernels at the training shapes, on the card.

    python scripts/bench_v2_backward.py

Both pool families run one backward: the match pass of
``csrc/fused_splade_v2_bwd.cu`` at a row block, then the dh and dW gathers
of ``csrc/fused_splade_bwd.cu``. At the document batch (B=128 S=256), the
query batch (B=64 S=64), a ragged length (B=8 S=200) and an odd batch (B=3
S=40, which the per-row family runs at row_block 1), H=768, V=50,000,
model-like random inputs with random lengths and a fully padded row
(``chip_smoke.py`` phase 2's kind of mask), times by CUDA events:

- the match pass at each of row_block 8, 4, 2 and 1 that divides B, each
  bitmask checked bitwise against row_block 1's; the per-row family's
  (``routed_row_block``) marked ``*``;
- the whole backward (match pass, dh gather, dW gather) at each of those
  row blocks, as ``launch_match_gather`` runs it;
- the dh gather from that bitmask at every (hidden slices, vocab splits) in
  a grid, with the partials' ordered sum, the rule both families take
  (``dh_splits``: whole hidden width, ``dh_vocab_splits_v2`` ranges) marked
  ``*``;
- the dW gather.

It chose ``DH_SPLIT_BLOCKS`` in ``ops/fused_splade.py``. Prints the card's
name and power limit first (about a minute).
"""

from __future__ import annotations

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
HIDDEN = (1, 2, 3, 6)
VOCAB = (1, 2, 3, 4, 6, 8, 12, 16)


def cuda_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_v2_backward: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip())
    lib = _cuda.library()
    stream = torch.cuda.current_stream().cuda_stream
    fam = fs.PER_ROW
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
            torch.randn(B, V, device="cuda", generator=gen), m).contiguous()
        ops = fs._bwd_operands(h, w, bias, mask, m, g_pre)
        routed = fs.routed_row_block(ops.hb)
        print(f"B={B} S={S}: {float(mask.mean()):.1%} of positions valid, "
              f"{int((g_pre != 0).sum())} live (b, v) columns; the per-row "
              f"family's row block {routed}")
        want = fs.launch_match(fam, ops, [1])
        for rb in (rb for rb in (8, 4, 2, 1) if B % rb == 0):
            got = fs.launch_match(fam, ops, [rb])
            same = bool(torch.equal(got, want))
            t = cuda_ms(lambda: fs.launch_match(fam, ops, [rb]))
            whole = cuda_ms(lambda: fs.launch_match_gather(
                fam, ops, [rb], ("dh", "dw")))
            mark = "*" if rb == routed else " "
            print(f"  rb={rb}{mark} match pass {t:.4f} ms, whole backward "
                  f"(match + dh + dW) {whole:.4f} ms, bitmask bitwise "
                  f"row_block 1's: {same}")
            if not same:
                raise SystemExit("the bitmask differs between row blocks")
        rule = fs.dh_splits(B, S, H, V)
        ref = None
        for hs in HIDDEN:
            row = []
            for vs in VOCAB:
                parts = torch.empty((vs, B, S, H), device="cuda")

                def run():
                    _cuda.check(lib.splade_fused_pool_bwd_dh(
                        want.data_ptr(), ops.wb.data_ptr(), ops.g.data_ptr(),
                        parts.data_ptr(), B, S, H, V, hs, vs, stream),
                        "splade_fused_pool_bwd_dh")
                    return fs.add_partials(parts)

                dh = run().clone()
                ref = dh if ref is None else ref
                err = float((dh - ref).abs().max() / ref.abs().max())
                if err > 1e-5:
                    raise SystemExit(f"dh at {hs}x{vs} differs by {err:.2e}")
                mark = "*" if (hs, vs) == rule else " "
                row.append(f"{vs:>2}{mark}{cuda_ms(run):7.3f}")
                del parts
            print(f"  dh gather, {hs} hidden slices, by vocab splits: "
                  + " ".join(row))
        t = cuda_ms(lambda: fs.launch_gather(fam, "dw", want, ops.hb, ops.g,
                                             S))
        print(f"  dW gather {t:.4f} ms; dh split (hidden, vocab) of both "
              f"families {rule} marked *")
    return 0


if __name__ == "__main__":
    sys.exit(main())
