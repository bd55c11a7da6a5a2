"""Fused SPLADE vocabulary projection + masked seq-max, with its gradient.

Counterpart of ``splade_tpu/ops/fused_splade.py::fused_splade_pool`` (a
``jax.custom_vjp``; here a ``torch.autograd.Function``):

    m[b, v]      = max over valid s of ( h[b,s,:] . W[v,:] + bias[v] )
    pooled[b, v] = log1p(relu(m[b, v]))
    token_w[b,s] = log1p(relu(max_v of the same)) * mask[b, s]

Forward kernel: ``csrc/fused_splade_fwd.cu`` replaces the Pallas
``_fwd_kernel`` (``splade_tpu/ops/fused_splade.py:50``). It is bound by
tensor-core operations (2·valid·H·V FLOP) and keeps every score in the
``mma.sync`` accumulator fragments, so only the [B, V] and [B, S] maxima
reach device memory. A block owns a vocab tile and the valid 16-row groups
of a few batch rows, which it lists from the mask itself (padding is never
loaded or multiplied); the blocks that run together share their W tile in
L2. Each score keeps the products of ``csrc/fused_splade_tile.cuh``, which
the backward's recompute equals bit for bit. The ragged last vocab tile is
masked in the kernel, so W is never padded or copied.

Backward: the forward saves m (the [B, V] maxima), h, w, bias and mask, as
``_fused_fwd`` does. Outside the kernels, as ``_fused_bwd`` does:
``g_pre = g · 1/(1+m)`` where m > 0 else 0, ``dbias = Σ_b g_pre``, and the
token weights' cotangent is ignored (they are monitoring-only). The
gradients themselves are ``G = 1[masked == m] · g_pre``, ``dh = G @ W`` and
``dW = Gᵀ @ h``, computed by three kernels that replace ``_bwd_dh_kernel``
at ``fused_splade.py:93`` and ``_bwd_dw_kernel`` at ``:111``: a match pass
recomputes every score of the batch once and writes the argmax set as a
bitmask ``match[b, j, v]`` (bit r of word j: valid position 32j + r
reaches m[b, v], and g_pre[b, v] != 0), then a dh gather and a dW gather
(``csrc/fused_splade_bwd.cu``) read it. Both kernel families run one match
pass, the row-blocked family's (``csrc/fused_splade_v2_bwd.cu``, on the
register-resident walk): this family launches it at ``routed_row_block``,
the largest of 8, 4, 2, 1 that divides B and whose shared memory fits. The
dh gather cuts each word row's vocabulary into ordered ranges where word
rows are few (``dh_splits``) and the ranges' f32 partials are added in
order. The autograd backward runs the match pass once and the gathers it
needs. Ties get duplicate gradient, as in the Pallas kernels (autograd
through ``amax``, the streamed path's gradient, splits them instead). dh
and dW come back in the dtypes of h and w.

On CUDA tensors the wrappers launch the kernels or raise; on CPU tensors
they run the plain versions ``fused_splade_pool_plain``,
``fused_splade_bwd_match_plain``, ``fused_splade_gather_dh_plain`` and
``fused_splade_gather_dw_plain`` (``fused_splade_bwd_plain`` is the three
composed). There is no fallback between the two.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from splade_tpu_torch.ops import _cuda
from splade_tpu_torch.ops.splade_pool import (NEG, masked_max_streamed,
                                              masked_scores)

#: vocab tile of the plain versions: the forward's maxima and the backward's
#: recompute use the same tile, so the recomputed scores equal m bitwise
PLAIN_TILE = 8192
#: hidden columns a gather block owns at most: the dW gather keeps them as
#: one row of f32 sums a warp, the dh gather as 32 rows in shared memory; a
#: wider hidden width is cut into slices
GATHER_SLICE_COLS = 768
#: hidden columns of one warp of the dh gather (32 threads x 4); a slice of
#: the hidden width is a whole number of them
GATHER_COLS = 128
#: the gathers' C entries, which both kernel families launch
GATHER_ENTRY = "splade_fused_pool_bwd_"
#: the match pass's C entry, which both kernel families launch
MATCH_ENTRY = "splade_fused_pool_v2_bwd_match"
#: vocab columns of a block of the walk (the forward and the match pass)
TILE_COLS = 128
#: positions of a tile of the walk: 8 groups of 16
TILE_ROWS = 128
#: shared memory one block may opt into on an H100, static and dynamic
MAX_SHARED_BYTES = 232_448
#: static shared memory of the walk kernels (the forward and the match pass):
#: a few flags, rounded up to the 128-byte alignment of the dynamic part.
#: The mirror of what the built kernels report (``_shared_bytes``)
STATIC_SHARED_BYTES = 128
#: the walk's cp.async ring: 4 stages of 128 h rows and 128 W rows, 32 + 8
#: bf16 each
RING_BYTES = 4 * 256 * 40 * 2
#: blocks the dh gather aims at, counting its vocab splits. Each block owns
#: a word row's full hidden width (one slice up to H = 768: 96 KB of sums,
#: two blocks an SM; wider, the fewest slices) and one vocab range; more,
#: shorter ranges spread a word row's serial walk of matches over more
#: blocks. Chosen on an H100 with scripts/bench_v2_backward.py: 4 ranges at
#: the document batch (1,024 word rows), the most (16) at the query batch
#: (128).
DH_SPLIT_BLOCKS = 4096
MAX_VOCAB_SPLITS = 16


def match_words(S: int) -> int:
    """32-position words a batch row of the bitmask holds: ceil(S / 32)."""
    return -(-S // 32)


def min_hidden_slices(H: int) -> int:
    """The fewest slices of whole GATHER_COLS-column groups that keep each
    at most GATHER_SLICE_COLS wide: 1 up to H = 768."""
    groups = max(-(-H // GATHER_COLS), 1)
    return -(-groups // (GATHER_SLICE_COLS // GATHER_COLS))


def dh_vocab_splits_v2(B: int, S: int, V: int) -> int:
    """How many ordered vocab ranges the dh gather cuts each word row's
    vocabulary into: enough that its blocks (word rows x ranges) reach
    DH_SPLIT_BLOCKS, at most one per 32 columns and MAX_VOCAB_SPLITS. A
    split is only taken while the B·ceil(S/32) word rows are fewer than
    DH_SPLIT_BLOCKS, so the [splits, B, S, H] f32 partials hold at most
    about DH_SPLIT_BLOCKS·32·H·4 bytes beyond dh itself: 403 MB at H = 768,
    302 MB at the document batch."""
    want = -(-DH_SPLIT_BLOCKS // max(B * match_words(S), 1))
    return max(1, min(want, -(-V // 32), MAX_VOCAB_SPLITS))


def dh_splits(B: int, S: int, H: int, V: int) -> Tuple[int, int]:
    """(hidden slices, vocab ranges) of the dh gather, for both kernel
    families: the fewest slices of the hidden width (one up to H = 768) and
    ``dh_vocab_splits_v2`` ranges."""
    return min_hidden_slices(H), dh_vocab_splits_v2(B, S, V)


def vocab_ranges(V: int, splits: int) -> list:
    """The dh gather's vocab ranges [(vb, ve), ...], one per split in the
    order their partial sums are added: ceil(ceil(V/32) / splits) * 32
    columns each (whole 32-column runs), a range past V empty. The C entry
    cuts the vocabulary the same way."""
    size = -(-(-(-V // 32)) // splits) * 32
    return [(min(z * size, V), min((z + 1) * size, V)) for z in range(splits)]


def add_partials(parts: torch.Tensor) -> torch.Tensor:
    """[splits, ...] partial sums added in split order, into parts[0]:
    ((p0 + p1) + p2) + ..., the order the plain gather adds them in."""
    out = parts[0]
    for z in range(1, parts.shape[0]):
        out += parts[z]
    return out


def float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 image of f32 values (the kernel's atomicMax
    key): signed-int order of the keys is float order of the values."""
    i = x.to(torch.float32).view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def float_from_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def fused_splade_pool_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch, f32 products over
    vocab tiles: (m [B, V], pos [B, S]) pre-activation maxima, invalid
    s -> -1e30."""
    return masked_max_streamed(h, w, bias, mask, tile=PLAIN_TILE)


def fused_splade_bwd_match_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, m: torch.Tensor, g_pre: torch.Tensor,
) -> torch.Tensor:
    """The match pass in plain PyTorch: each score tile recomputed as
    ``fused_splade_pool_plain`` computed it; bit r of ``match[b, j, v]`` set
    where valid position 32j + r has ``score == m[b, v]`` and ``g_pre[b, v]
    != 0``. Returns int32 [B, ceil(S/32), V] holding the kernel's uint32
    words (bit 31 is the sign bit)."""
    B, S, _ = h.shape
    V = w.shape[0]
    J = match_words(S)
    dev = h.device
    match = torch.zeros((B, J, V), dtype=torch.int32, device=dev)
    with torch.autocast(dev.type, enabled=False):
        x = h.to(torch.float32)
        valid = mask.to(device=dev).to(torch.bool)[:, :, None]
        for v0 in range(0, V, PLAIN_TILE):
            cols = slice(v0, v0 + PLAIN_TILE)
            masked = masked_scores(x, w, bias, valid, v0, PLAIN_TILE)
            hit = ((masked == m[:, None, cols]) & valid
                   & (g_pre[:, None, cols] != 0))
            hit = torch.nn.functional.pad(hit, (0, 0, 0, J * 32 - S))
            hit = hit.view(B, J, 32, -1).to(torch.int32)
            words = match[:, :, cols]
            for r in range(32):
                words |= hit[:, :, r] << r
    return match


def _unpack_tile(match: torch.Tensor, S: int) -> torch.Tensor:
    """[B, J, T] words -> [B, S, T] bool: bit r of word j is position 32j+r."""
    B, J, T = match.shape
    r = torch.arange(32, dtype=torch.int32, device=match.device)
    bits = (match[:, :, None, :] >> r[None, None, :, None]) & 1
    return bits.view(B, J * 32, T)[:, :S].to(torch.bool)


def fused_splade_gather_dh_plain(match: torch.Tensor, w: torch.Tensor,
                                 g_pre: torch.Tensor, S: int,
                                 vocab_splits: int = 1) -> torch.Tensor:
    """The dh gather in plain PyTorch: ``dh[b, s] = Σ_v bit(b, s, v) ·
    g_pre[b, v] · W[v]`` over vocab tiles, each of the kernel's vocab ranges
    (``vocab_ranges``) summed on its own and the ranges' partials added in
    order. Returns dh [B, S, H] f32."""
    B, _, V = match.shape
    parts = torch.zeros((vocab_splits, B, S, w.shape[1]), dtype=torch.float32,
                        device=match.device)
    with torch.autocast(match.device.type, enabled=False):
        for part, (vb, ve) in zip(parts, vocab_ranges(V, vocab_splits)):
            for v0 in range(vb, ve, PLAIN_TILE):
                cols = slice(v0, min(v0 + PLAIN_TILE, ve))
                G = torch.where(_unpack_tile(match[:, :, cols], S),
                                g_pre[:, None, cols].to(torch.float32), 0.0)
                part += G @ w[cols].to(torch.float32)
    return add_partials(parts)


def fused_splade_gather_dw_plain(match: torch.Tensor, h: torch.Tensor,
                                 g_pre: torch.Tensor) -> torch.Tensor:
    """The dW gather in plain PyTorch: ``dW[v] = Σ_b Σ_s bit(b, s, v) ·
    g_pre[b, v] · h[b, s]`` over vocab tiles. Returns dW [V, H] f32."""
    B, S, H = h.shape
    V = match.shape[2]
    dw = torch.empty((V, H), dtype=torch.float32, device=h.device)
    with torch.autocast(h.device.type, enabled=False):
        x = h.to(torch.float32)
        for v0 in range(0, V, PLAIN_TILE):
            cols = slice(v0, v0 + PLAIN_TILE)
            G = torch.where(_unpack_tile(match[:, :, cols], S),
                            g_pre[:, None, cols].to(torch.float32), 0.0)
            dw[cols] = torch.einsum("bsv,bsh->vh", G, x)
    return dw


def fused_splade_bwd_plain(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor, m: torch.Tensor, g_pre: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch: the plain match
    pass, then the two plain gathers from its bitmask.
    Returns (dh [B, S, H] f32, dw [V, H] f32)."""
    match = fused_splade_bwd_match_plain(h, w, bias, mask, m, g_pre)
    return (fused_splade_gather_dh_plain(match, w, g_pre, h.shape[1]),
            fused_splade_gather_dw_plain(match, h, g_pre))


def _operands(h, w, bias, mask):
    """bf16 h and w (no copy when they already are), f32 mask and bias, on
    h's device, checked for what the kernels take."""
    B, S, H = h.shape
    if w.dim() != 2 or w.shape[1] != H or mask.shape != (B, S):
        raise ValueError(f"shapes h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"mask {tuple(mask.shape)} do not agree")
    if H % 8:
        raise ValueError(f"hidden size {H} must be a multiple of 8")
    dev = h.device
    hb = h.to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16).contiguous()
    for name, t in (("h", hb), ("w", wb)):
        if t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a 16-byte aligned tensor on {dev}")
    maskf = mask.to(device=dev, dtype=torch.float32).contiguous()
    bias_f = (bias.to(device=dev, dtype=torch.float32).contiguous()
              if bias is not None else None)
    return hb, wb, bias_f, maskf


@dataclasses.dataclass(frozen=True)
class BwdOperands:
    """What the backward kernels take, prepared once a backward."""

    hb: torch.Tensor
    wb: torch.Tensor
    bias: Optional[torch.Tensor]
    mask: torch.Tensor
    m: torch.Tensor
    g: torch.Tensor

    @property
    def dims(self) -> Tuple[int, int, int, int]:
        B, S, H = self.hb.shape
        return B, S, H, self.wb.shape[0]

    def ptr(self, name: str):
        t = getattr(self, name)
        return t.data_ptr() if t is not None else None


def _bwd_operands(h, w, bias, mask, m, g_pre) -> BwdOperands:
    hb, wb, bias_f, maskf = _operands(h, w, bias, mask)
    B, _, _ = hb.shape
    V = wb.shape[0]
    dev = hb.device
    m32 = m.to(device=dev, dtype=torch.float32).contiguous()
    g32 = g_pre.to(device=dev, dtype=torch.float32).contiguous()
    if m32.shape != (B, V) or g32.shape != (B, V):
        raise ValueError(f"m {tuple(m.shape)} and g_pre {tuple(g_pre.shape)} "
                         f"must be [{B}, {V}]")
    return BwdOperands(hb, wb, bias_f, maskf, m32, g32)


def pick_row_block(B: int) -> int:
    """The largest of 8, 4, 2, 1 that divides B."""
    return next(rb for rb in (8, 4, 2, 1) if B % rb == 0)


def resolve_row_block(B: int, row_block: int) -> int:
    if row_block < 0 or (row_block and B % row_block):
        # a block that does not divide B would leave the tail rows
        # uncomputed (no output, dropped gradients): refuse instead
        raise ValueError(
            f"row_block={row_block} must divide batch {B} "
            "(or pass 0 to pick a dividing block automatically)")
    return row_block or pick_row_block(B)


def fwd_shared_bytes(S: int, row_block: int) -> int:
    """Dynamic shared memory of the row-blocked forward at sequence length
    S: the ring, the row block's column keys, the row maxima of a tile's two
    column halves, the bias and the list of 16-row groups. A mirror of
    ``shared_bytes`` in ``fused_splade_fwd.cu``, which the launch path asks
    instead (``_check``); a test on the card holds the two equal."""
    G = -(-S // 16)
    return (RING_BYTES + row_block * TILE_COLS * 4 + 2 * TILE_ROWS * 4
            + TILE_COLS * 4 + row_block * G * 8)


def match_shared_bytes(S: int, row_block: int) -> int:
    """Dynamic shared memory of the match pass at sequence length S: the
    ring, m for the row block's rows and the tile's columns, the bias, the
    list of 16-row groups and the row and group flags. A mirror of
    ``shared_bytes`` in ``fused_splade_v2_bwd.cu``, as above."""
    G = -(-S // 16)
    return (RING_BYTES + row_block * TILE_COLS * 4 + TILE_COLS * 4
            + row_block * G * 8 + row_block * 4 + row_block * G)


def _shared_bytes(h, RB: int, backward: bool) -> Tuple[int, int]:
    """(dynamic, static) shared memory a block of the match pass
    (``backward``) or of the row-blocked forward takes at h's sequence
    length and row block RB: the built kernels' own numbers for a CUDA
    tensor (their C entries report them), the mirrors on the CPU."""
    S = h.shape[1]
    kernel = "bwd" if backward else "fwd"
    if h.is_cuda:
        lib = _cuda.library()
        static = getattr(lib, f"splade_fused_pool_v2_{kernel}_static_bytes")()
        if static < 0:
            raise _cuda.KernelLaunchError(
                f"the {kernel} walk kernel's attributes are unreadable")
        return (getattr(lib, f"splade_fused_pool_v2_{kernel}_shared_bytes")(
            S, RB), static)
    return ((match_shared_bytes if backward else fwd_shared_bytes)(S, RB),
            STATIC_SHARED_BYTES)


def _check(h, row_block: int, backward: bool) -> int:
    """The row block the walk kernels run at, refused where the forward's
    or the match pass's shared memory would not fit: both keep a row per
    batch row of the block and list its 16-row groups, so a large row block
    at a long sequence overflows. The hidden width bounds neither (both
    stream it)."""
    B, S, _ = h.shape
    RB = resolve_row_block(B, row_block)
    need, static = _shared_bytes(h, RB, backward)
    if need + static > MAX_SHARED_BYTES:
        what = (f"the match pass stages m for {RB} batch rows and lists "
                f"their 16-row groups at S={S}" if backward else
                f"the forward keeps column maxima for {RB} batch rows and "
                f"lists their 16-row groups at S={S}")
        raise ValueError(
            f"row_block {RB} at S={S} needs {need} bytes of dynamic shared "
            f"memory a block beside {static} static (at most "
            f"{MAX_SHARED_BYTES} in all): {what}")
    return RB


def routed_row_block(h) -> int:
    """The row block this module's family runs the match pass at: the
    largest of 8, 4, 2, 1 that divides B and whose shared memory fits (rb 8
    up to S = 32,384, rb 1 up to S = 265,536, past which ``_check``
    refuses)."""
    B = h.shape[0]
    rb = next((rb for rb in (8, 4, 2) if B % rb == 0
               and sum(_shared_bytes(h, rb, True)) <= MAX_SHARED_BYTES), 1)
    return _check(h, rb, True)


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    """What differs between the pool's kernel families: the per-row one of
    this module and the row-blocked one of ``ops/fused_splade_v2.py``. The
    launchers and the ``autograd.Function`` below serve both, so operand
    preparation, the empty batch and the tie, dbias and autocast rules are
    written once."""

    #: the forward's C entry; the match pass's (MATCH_ENTRY) and the
    #: gathers' (GATHER_ENTRY) are shared
    fwd_entry: str
    #: (hb, row_block, backward) -> the ints the forward (backward False)
    #: or match (True) C entry takes after V; raises ValueError for what the
    #: kernels cannot take
    block_args: Callable
    #: the plain versions, taking row_block as their last argument
    plain_fwd: Callable
    plain_match: Callable
    plain_bwd: Callable
    #: kernel ("fwd", "match", "dh", "dw") -> the public function
    #: whose ``launches`` counts it, filled in where those are defined
    counted: Dict[str, Callable] = dataclasses.field(default_factory=dict)


def _launch_fwd(fam: KernelFamily, h, w, bias, mask, row_block
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    hb, wb, bias_f, maskf = _operands(h, w, bias, mask)
    B, S, H = hb.shape
    V = wb.shape[0]
    extra = fam.block_args(hb, row_block, False)
    dev = hb.device
    m = torch.empty((B, V), dtype=torch.float32, device=dev)
    pos_key = torch.full((B, S), int(float_key(torch.tensor(NEG))),
                         dtype=torch.int32, device=dev)
    if B == 0 or S == 0 or V == 0:
        return torch.full_like(m, NEG), float_from_key(pos_key)
    entry = fam.fwd_entry
    code = getattr(_cuda.library(), entry)(
        hb.data_ptr(), wb.data_ptr(),
        bias_f.data_ptr() if bias_f is not None else None,
        maskf.data_ptr(), m.data_ptr(), pos_key.data_ptr(),
        B, S, H, V, *extra, _cuda.stream_ptr(hb))
    _cuda.check(code, entry)
    fam.counted["fwd"].launches += 1
    return m, float_from_key(pos_key)


def _launch_bwd(fam: KernelFamily, which, h, w, bias, mask, m, g_pre,
                row_block) -> Dict[str, torch.Tensor]:
    """The family's backward kernels for the outputs named in ``which``
    ("dh" [B,S,H], "dw" [V,H], f32). An empty batch launches nothing and
    gives zeros."""
    ops = _bwd_operands(h, w, bias, mask, m, g_pre)
    extra = fam.block_args(ops.hb, row_block, True)
    B, S, H, V = ops.dims
    if B == 0 or S == 0 or V == 0:
        shapes = {"dh": (B, S, H), "dw": (V, H)}
        return {name: torch.zeros(shapes[name], dtype=torch.float32,
                                  device=ops.hb.device) for name in which}
    return launch_match_gather(fam, ops, extra, which)


def launch_match(fam: KernelFamily, ops: BwdOperands, extra=()
                 ) -> torch.Tensor:
    """The match pass (``extra``: the family's block arguments, its row
    block), counted as the family's: the bitmask [B, ceil(S/32), V] (int32
    holding the kernel's uint32 words), every word written by the kernel."""
    B, S, H, V = ops.dims
    match = torch.empty((B, match_words(S), V), dtype=torch.int32,
                        device=ops.hb.device)
    code = getattr(_cuda.library(), MATCH_ENTRY)(
        ops.ptr("hb"), ops.ptr("wb"), ops.ptr("bias"), ops.ptr("mask"),
        ops.ptr("m"), ops.ptr("g"), match.data_ptr(), B, S, H, V, *extra,
        _cuda.stream_ptr(ops.hb))
    _cuda.check(code, MATCH_ENTRY)
    fam.counted["match"].launches += 1
    return match


def launch_gather(fam: KernelFamily, which: str, match: torch.Tensor,
                  x: torch.Tensor, g32: torch.Tensor, S: int) -> torch.Tensor:
    """The dh gather ("dh": x is bf16 w, out [B,S,H]) or the dW gather
    ("dw": x is bf16 h, out [V,H]) from a bitmask [B, ceil(S/32), V], f32,
    every element written by the kernel; dh's partials over the vocab
    ranges of ``dh_splits`` are added in order."""
    B, J, V = match.shape
    H = x.shape[-1]
    if (J != match_words(S) or match.dtype != torch.int32
            or g32.shape != (B, V)
            or x.shape != ((V, H) if which == "dh" else (B, S, H))):
        raise ValueError(f"match {tuple(match.shape)} {match.dtype}, g "
                         f"{tuple(g32.shape)} and {tuple(x.shape)} do not "
                         f"agree for the {which} gather at S={S}")
    match = match.contiguous()
    splits = dh_splits(B, S, H, V) if which == "dh" else ()
    out = torch.empty(((splits[1], B, S, H) if which == "dh" else (V, H)),
                      dtype=torch.float32, device=x.device)
    entry = GATHER_ENTRY + which
    code = getattr(_cuda.library(), entry)(
        match.data_ptr(), x.data_ptr(), g32.data_ptr(), out.data_ptr(),
        B, S, H, V, *splits, _cuda.stream_ptr(x))
    _cuda.check(code, entry)
    fam.counted[which].launches += 1
    return add_partials(out) if which == "dh" else out


def launch_match_gather(fam: KernelFamily, ops: BwdOperands, extra, which
                        ) -> Dict[str, torch.Tensor]:
    """One match pass, then the gathers in ``which``: one recompute serves
    both gradients."""
    match = launch_match(fam, ops, extra)
    S = ops.hb.shape[1]
    return {name: launch_gather(fam, name, match,
                                ops.wb if name == "dh" else ops.hb, ops.g, S)
            for name in which}


def family_maxima(fam: KernelFamily, h, w, bias, mask, row_block=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m [B, V], pos [B, S]): the family's forward kernel on a CUDA tensor,
    its plain version on a CPU tensor."""
    if h.is_cuda:
        return _launch_fwd(fam, h, w, bias, mask, row_block)
    return fam.plain_fwd(h, w, bias, mask, row_block)


def family_match(fam: KernelFamily, h, w, bias, mask, m, g_pre,
                 row_block=None) -> torch.Tensor:
    """The argmax bitmask, int32 [B, ceil(S/32), V]: the family's match pass
    on a CUDA tensor, its plain version on a CPU tensor."""
    if not h.is_cuda:
        return fam.plain_match(h, w, bias, mask, m, g_pre, row_block)
    ops = _bwd_operands(h, w, bias, mask, m, g_pre)
    extra = fam.block_args(ops.hb, row_block, True)
    B, S, _, V = ops.dims
    if B == 0 or S == 0 or V == 0:
        return torch.zeros((B, match_words(S), V), dtype=torch.int32,
                           device=ops.hb.device)
    return launch_match(fam, ops, extra)


def family_backward(fam: KernelFamily, which, h, w, bias, mask, m, g_pre,
                    row_block=None) -> Dict[str, torch.Tensor]:
    """{"dh": [B, S, H], "dw": [V, H]} f32 for the names in ``which``: the
    family's backward kernels on a CUDA tensor, its plain backward on a CPU
    tensor."""
    if h.is_cuda:
        return _launch_bwd(fam, which, h, w, bias, mask, m, g_pre, row_block)
    dh, dw = fam.plain_bwd(h, w, bias, mask, m, g_pre, row_block)
    return {name: {"dh": dh, "dw": dw}[name] for name in which}


def family_bwd(fam: KernelFamily, which: str, h, w, bias, mask, m, g_pre,
               row_block=None) -> torch.Tensor:
    """dh [B, S, H] or dW [V, H] f32 alone (``which`` "dh" or "dw")."""
    return family_backward(fam, (which,), h, w, bias, mask, m, g_pre,
                           row_block)[which]


def fold_cotangent(g_pooled: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """g_pre = g · d log1p(relu(m)) / dm = g / (1 + m) where m > 0, else 0."""
    m = m.to(torch.float32)
    return g_pooled.to(torch.float32) * torch.where(
        m > 0, 1.0 / (1.0 + m), torch.zeros_like(m))


class _FusedPool(torch.autograd.Function):
    """Counterpart of the ``jax.custom_vjp``s (``fused_splade.py:173-222``,
    ``fused_splade_v2.py:126-215``) over one kernel family.
    ``custom_fwd``/``custom_bwd`` run the backward under the forward's
    autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, h, w, bias, mask, fam, row_block):
        m, pos = family_maxima(fam, h, w, bias, mask, row_block)
        ctx.save_for_backward(h, w, bias, mask, m)
        ctx.family = fam, row_block
        pooled = torch.log1p(torch.relu(m))
        token_weights = (torch.log1p(torch.relu(pos))
                         * mask.to(device=pos.device, dtype=torch.float32))
        ctx.mark_non_differentiable(token_weights)
        return pooled, token_weights

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g_pooled, _g_token_weights):
        h, w, bias, mask, m = ctx.saved_tensors
        fam, rb = ctx.family
        g_pre = fold_cotangent(g_pooled, m)
        which = tuple(name for name, need in zip(("dh", "dw"),
                                                 ctx.needs_input_grad[:2])
                      if need)
        grads = (family_backward(fam, which, h, w, bias, mask, m, g_pre, rb)
                 if which else {})
        dbias = None
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = g_pre.sum(0).to(bias.dtype)
        return (grads["dh"].to(h.dtype) if "dh" in grads else None,
                grads["dw"].to(w.dtype) if "dw" in grads else None,
                dbias, None, None, None)


def family_pool(fam: KernelFamily, h, w, bias, mask, row_block=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, token_weights) through the family's kernels, differentiable
    in h, w and bias."""
    return _FusedPool.apply(h, w, bias, mask, fam, row_block)


# the plain versions are looked up when called, not when the family is made
PER_ROW = KernelFamily(
    fwd_entry="splade_fused_pool_fwd",
    block_args=lambda hb, _rb, backward: (
        [routed_row_block(hb)] if backward else []),
    plain_fwd=lambda h, w, bias, mask, _rb: fused_splade_pool_plain(
        h, w, bias, mask),
    plain_match=lambda *args: fused_splade_bwd_match_plain(*args[:6]),
    plain_bwd=lambda *args: fused_splade_bwd_plain(*args[:6]))


def fused_splade_maxima(h, w, bias, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m [B, V], pos [B, S]) pre-activation maxima: the forward kernel on a
    CUDA tensor, its plain version on a CPU tensor."""
    return family_maxima(PER_ROW, h, w, bias, mask)


def fused_splade_bwd_match(h, w, bias, mask, m, g_pre) -> torch.Tensor:
    """The argmax bitmask, int32 [B, ceil(S/32), V]: the match pass at
    ``routed_row_block`` on a CUDA tensor, ``fused_splade_bwd_match_plain``
    on a CPU tensor."""
    return family_match(PER_ROW, h, w, bias, mask, m, g_pre)


def _gather(which: str, match, x, g_pre, S: int) -> torch.Tensor:
    xb = x.to(torch.bfloat16).contiguous()
    g32 = g_pre.to(device=xb.device, dtype=torch.float32).contiguous()
    B, _, V = match.shape
    if B == 0 or S == 0 or V == 0:
        return torch.zeros((B, S, xb.shape[-1]) if which == "dh"
                           else (V, xb.shape[-1]), dtype=torch.float32,
                           device=xb.device)
    return launch_gather(PER_ROW, which, match, xb, g32, S)


def fused_splade_gather_dh(match, w, g_pre, S: int) -> torch.Tensor:
    """dh [B, S, H] f32 from a bitmask: the dh gather on a CUDA tensor,
    ``fused_splade_gather_dh_plain`` on a CPU tensor."""
    if not w.is_cuda:
        return fused_splade_gather_dh_plain(match, w, g_pre, S)
    return _gather("dh", match, w, g_pre, S)


def fused_splade_gather_dw(match, h, g_pre) -> torch.Tensor:
    """dW [V, H] f32 from a bitmask: the dW gather on a CUDA tensor,
    ``fused_splade_gather_dw_plain`` on a CPU tensor."""
    if not h.is_cuda:
        return fused_splade_gather_dw_plain(match, h, g_pre)
    return _gather("dw", match, h, g_pre, h.shape[1])


def fused_splade_bwd_dh(h, w, bias, mask, m, g_pre) -> torch.Tensor:
    """dh [B, S, H] f32 of the pool: the match pass and the dh gather on a
    CUDA tensor, the plain version on a CPU tensor."""
    return family_bwd(PER_ROW, "dh", h, w, bias, mask, m, g_pre)


def fused_splade_bwd_dw(h, w, bias, mask, m, g_pre) -> torch.Tensor:
    """dW [V, H] f32 of the pool: the match pass and the dW gather on a
    CUDA tensor, the plain version on a CPU tensor."""
    return family_bwd(PER_ROW, "dw", h, w, bias, mask, m, g_pre)


def fused_splade_pool(
    h: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled [B, V] f32, token_weights [B, S] f32) from h [B, S, H], tied
    decoder w [V, H], bias [V] or None, attention mask [B, S]. Differentiable
    in h, w and bias; token_weights carries no gradient."""
    return family_pool(PER_ROW, h, w, bias, mask)


#: kernel launches since the last reset, added where a kernel is launched
#: and nowhere else (never for the plain versions or an empty batch):
#: the forward, the match pass, the dh gather and the dW gather
fused_splade_pool.launches = 0
fused_splade_bwd_match.launches = 0
fused_splade_bwd_dh.launches = 0
fused_splade_bwd_dw.launches = 0
PER_ROW.counted.update(fwd=fused_splade_pool, match=fused_splade_bwd_match,
                       dh=fused_splade_bwd_dh, dw=fused_splade_bwd_dw)
