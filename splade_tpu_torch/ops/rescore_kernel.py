"""Exact phase-2 rescore of two-phase postings search.

Counterpart of ``splade_tpu/ops/rescore_kernel.py``: ``rescore_match`` and
``rescore_match_rows`` keep their signatures and outputs,

    score[b, c] = sum_t q_val[b, t] * sum_m w[b, c, m]
                                    * [ d_terms[cand[b, c], m] == q_idx[b, t] ]
    w = float(int8 d_vals[cand]) * d_scale[cand]

with duplicate query terms accumulating and pad slots (doc id V / value 0,
query value 0) contributing nothing.

Kernel: ``csrc/rescore.cu`` replaces both Pallas kernels
(``_rescore_kernel`` :54 and ``_rescore_kernel_rows`` :127). They differ
only in a TPU lane layout, so one Hopper kernel is the counterpart of both.
It is bound by the bytes of the gathered candidate rows (~10 MB, ~3 us at
B=32, C=1000, M=64). A block builds its query row into a hash table in
shared memory (each term's values summed in ascending t, so a repeated call
is bitwise), and 8 lanes read each candidate's doc-major row straight from
device memory (the row gather is fused in), one table lookup a slot. Term
ids must be int32 on the device; at M % 8 == 0 the rows are read in 16-byte
(terms) and 8-byte (values) vectors, so they must start aligned.

On a CUDA tensor both functions launch the kernel or raise; on a CPU
tensor they run ``rescore_match_plain``, the match formulation of
``splade_tpu``'s ``rescore_match_xla``.
"""

from __future__ import annotations

import torch

from splade_tpu_torch.ops import _cuda

MAX_T = 256  # the kernel's shared-memory query capacity


def rescore_match_plain(d_terms, d_vals, d_scale, q_idx, q_val, cand):
    """The kernel's function in plain PyTorch: a T-step loop that streams
    the gathered [B, C, M] candidate rows once per query term."""
    cand = cand.long()
    terms_c = d_terms[cand].to(torch.int64)                       # [B, C, M]
    w_c = d_vals[cand].to(torch.float32) * d_scale[cand][:, :, None]
    acc = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    q_idx = q_idx.to(torch.int64)
    q_val = q_val.to(torch.float32)
    for t in range(q_idx.shape[1]):
        hit = torch.where(terms_c == q_idx[:, t, None, None], w_c,
                          torch.zeros_like(w_c))
        acc = acc + q_val[:, t, None] * hit.sum(-1)
    return acc


def _launch(d_terms, d_vals, d_scale, q_idx, q_val, cand) -> torch.Tensor:
    N, M = d_terms.shape
    B, C = cand.shape
    T = q_idx.shape[1]
    dev = cand.device
    if d_terms.dtype != torch.int32 or d_vals.dtype != torch.int8:
        raise ValueError("the rescore kernel takes int32 term ids and int8 "
                         f"values, got {d_terms.dtype} / {d_vals.dtype}")
    if d_vals.shape != (N, M) or d_scale.shape != (N,) or q_val.shape != (B, T):
        raise ValueError("shapes of d_terms/d_vals/d_scale/q_idx/q_val "
                         "do not agree")
    if T > MAX_T:
        raise ValueError(f"query_top_t {T} exceeds the kernel's {MAX_T}")
    for name, t in (("d_terms", d_terms), ("d_vals", d_vals),
                    ("d_scale", d_scale)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    # the M % 8 == 0 path reads 16-byte term and 8-byte value vectors
    if M % 8 == 0 and (d_terms.data_ptr() % 16 or d_vals.data_ptr() % 8):
        raise ValueError("d_terms / d_vals rows must start 16 / 8-byte "
                         "aligned")
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0 or C == 0:
        return out
    if N == 0:
        return out.zero_()
    qi = q_idx.to(device=dev, dtype=torch.int32).contiguous()
    qv = q_val.to(device=dev, dtype=torch.float32).contiguous()
    ci = cand.to(torch.int32).contiguous()
    scale = d_scale.to(torch.float32)
    code = _cuda.library().splade_rescore_match(
        d_terms.data_ptr(), d_vals.data_ptr(), scale.data_ptr(),
        qi.data_ptr(), qv.data_ptr(), ci.data_ptr(), out.data_ptr(),
        N, B, C, M, T, _cuda.stream_ptr(out))
    _cuda.check(code, "splade_rescore_match")
    rescore_match.launches += 1
    return out


def rescore_match(d_terms, d_vals, d_scale, q_idx, q_val, cand):
    """EXACT f32 candidate scores [B, C] (``exact_rescore``'s output).

    d_terms [N, M] (pad id = V, pad val 0), d_vals [N, M] int8 with per-doc
    d_scale [N]; q_idx/q_val [B, T] sparse queries (pad val 0); cand [B, C]
    doc ids."""
    if cand.is_cuda:
        return _launch(d_terms, d_vals, d_scale, q_idx, q_val, cand)
    return rescore_match_plain(d_terms, d_vals, d_scale, q_idx, q_val, cand)


def rescore_match_rows(d_terms, d_vals, d_scale, q_idx, q_val, cand):
    """``splade_tpu``'s [B, C, M]-layout variant of ``rescore_match``. The
    layout was a TPU lane choice; on Hopper it is the same kernel."""
    return rescore_match(d_terms, d_vals, d_scale, q_idx, q_val, cand)


#: kernel launches since the last reset, through either public function
rescore_match.launches = 0
