"""The encoder's residual add and the LayerNorm after it, fused on the card.

Every residual add of ``models/modernbert.py`` is followed by a bias-free
LayerNorm: the attention's add by the layer's ``mlp_norm``, the MLP's add by
the next layer's ``attn_norm`` (the last one's by ``final_norm``). Training
under autocast keeps the residual stream in f32 (ROADMAP.md §3), so eagerly
each site is a mixed bf16 + f32 add, an f32 LayerNorm and the cast of its
output to bf16 inside the next ``nn.Linear``, and more than twice that in
the backward. Here one ``torch.autograd.Function`` over two hand-written
kernels (``csrc/add_layernorm.cu``) does a site in one pass each way:

- ``add_layer_norm(residual, branch, weight, eps, out_dtype)`` returns
  ``(r', n)``: ``r' = residual + branch`` in f32, bitwise the eager mixed
  add, and ``n = LayerNorm(r') * weight`` in ``out_dtype`` (bf16 for a
  product's operand, f32 for the encoder's output), with mean and variance
  in f32 over the row. With no branch it returns ``(residual, n)``: the
  embedding's norm.
- Its backward takes the gradients of ``r'`` (none where ``r'`` is not used
  again) and of ``n`` and writes the residual's f32 gradient, the branch's
  (the same values rounded to its dtype) and the weight's, summed over the
  rows in a fixed order.

No TPU kernel is replaced: XLA fuses the JAX package's plain add and norm
(``csrc/add_layernorm.cu`` says what bounds the pair and how it is laid
out). The model takes it where ``fused_add_norm_applies``; everything else
(CPU tensors, f32 or f64 runs, bf16 serving without autocast, another
width) keeps the eager add and ``nn.LayerNorm``.

On CUDA tensors the wrappers ``add_layernorm_fwd`` and ``add_layernorm_bwd``
launch the kernels or raise; on CPU tensors they run the plain versions
``add_layernorm_fwd_plain`` and ``add_layernorm_bwd_plain``. There is no
fallback between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from splade_tpu_torch.ops import _cuda

#: hidden widths the kernels are built for: 256 J, J = 1 to 4
KERNEL_WIDTHS = (256, 512, 768, 1024)
#: rows a block of 8 warps owns in each kernel (the backward writes one
#: partial row of the weight's gradient a block); the fastest of 8-256 at
#: the V33 micro-batch on an H100 (chip_smoke.py's check_add_norm)
FWD_ROWS_PER_BLOCK = 8
BWD_ROWS_PER_BLOCK = 64


def fused_add_norm_applies(norm: nn.Module, residual: torch.Tensor,
                           branch: Optional[torch.Tensor]) -> bool:
    """Whether ``add_layer_norm`` takes this site: an f32 residual on the
    card whose norm feeds a bf16 product (a bf16 branch of its shape, or,
    with no branch, bf16 autocast), and a bias-free ``nn.LayerNorm`` with
    an f32 weight over a width of ``KERNEL_WIDTHS``."""
    if not (isinstance(norm, nn.LayerNorm) and residual.is_cuda
            and residual.dtype == torch.float32):
        return False
    if branch is not None:
        operand_ok = (branch.dtype == torch.bfloat16
                      and branch.shape == residual.shape)
    else:
        operand_ok = (torch.is_autocast_enabled("cuda")
                      and torch.get_autocast_dtype("cuda") == torch.bfloat16)
    H = residual.shape[-1]
    return (operand_ok and norm.bias is None and norm.weight is not None
            and norm.weight.dtype == torch.float32
            and tuple(norm.normalized_shape) == (H,) and H in KERNEL_WIDTHS)


def _wide(*dtypes: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: f32, or f64 for f64."""
    out = torch.float32
    for dt in dtypes:
        out = torch.promote_types(out, dt)
    return out


def add_layernorm_fwd_plain(residual: torch.Tensor,
                            branch: Optional[torch.Tensor],
                            weight: torch.Tensor, eps: float,
                            out_dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The forward kernel's function in plain PyTorch: ``(r', n, stats)``
    with ``r' = residual + branch`` (``residual`` itself with no branch),
    ``n`` the bias-free LayerNorm of ``r'`` times ``weight`` in
    ``out_dtype``, mean and variance in two passes, and ``stats`` [2,
    ...leading dims] its mean and rstd, all computed in f32 (f64 for f64)."""
    wide = _wide(residual.dtype, weight.dtype)
    with torch.autocast(residual.device.type, enabled=False):
        r = residual if branch is None else residual + branch
        x = r.to(wide)
        mean = x.mean(-1)
        xc = x - mean[..., None]
        rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
        n = (xc * rstd[..., None] * weight.to(wide)).to(out_dtype)
        return r, n, torch.stack([mean, rstd])


def add_layernorm_bwd_plain(dn: torch.Tensor, r_out: torch.Tensor,
                            stats: torch.Tensor, weight: torch.Tensor,
                            d_residual: Optional[torch.Tensor],
                            branch_dtype: Optional[torch.dtype]
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                       torch.Tensor]:
    """The backward kernels' function in plain PyTorch: ``(dr, db,
    dweight)`` from the gradient of ``n`` and of ``r'`` (``d_residual``,
    None for none): ``dr = rstd * (g - mean(g) - xh * mean(g * xh)) +
    d_residual`` with ``g = dn * weight`` and ``xh`` the normalised row, in
    ``r_out``'s dtype; ``db`` those values in ``branch_dtype`` (None with no
    branch); ``dweight`` the sum of ``dn * xh`` over every row."""
    wide = _wide(r_out.dtype, dn.dtype, weight.dtype)
    with torch.autocast(r_out.device.type, enabled=False):
        mean, rstd = (s.to(wide)[..., None] for s in stats)
        xh = (r_out.to(wide) - mean) * rstd
        d = dn.to(wide)
        g = d * weight.to(wide)
        dr = rstd * (g - g.mean(-1, keepdim=True)
                     - xh * (g * xh).mean(-1, keepdim=True))
        if d_residual is not None:
            dr = dr + d_residual.to(wide)
        dr = dr.to(r_out.dtype)
        db = None if branch_dtype is None else dr.to(branch_dtype)
        dweight = (d * xh).reshape(-1, xh.shape[-1]).sum(0).to(weight.dtype)
        return dr, db, dweight


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous from a 16-byte aligned address, as the kernels'
    vector loads read it (no copy where it already is)."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}: the "
                         f"kernels take {dtype} {tuple(shape)}")


def _check_width(H: int) -> None:
    if H not in KERNEL_WIDTHS:
        raise ValueError(f"width {H}: the add + LayerNorm kernels are built "
                         f"for {KERNEL_WIDTHS}")


_N_DTYPES = (torch.bfloat16, torch.float32)


def _launch_fwd(residual, branch, weight, eps, out_dtype):
    H = residual.shape[-1]
    _check_width(H)
    _check("residual", residual, torch.float32, residual.shape)
    _check("weight", weight, torch.float32, (H,))
    if branch is not None:
        _check("branch", branch, torch.bfloat16, residual.shape)
    if out_dtype not in _N_DTYPES:
        raise ValueError(f"the forward kernel writes bf16 or f32, not "
                         f"{out_dtype}")
    r, w = _aligned(residual), _aligned(weight)
    b = None if branch is None else _aligned(branch)
    rows = r.numel() // H
    r_out = r if b is None else torch.empty_like(r)
    n = torch.empty(r.shape, dtype=out_dtype, device=r.device)
    stats = torch.empty((2, *r.shape[:-1]), dtype=torch.float32,
                        device=r.device)
    if rows == 0:
        return r_out, n, stats
    entry = "splade_add_layernorm_fwd"
    code = getattr(_cuda.library(), entry)(
        r.data_ptr(), None if b is None else b.data_ptr(), w.data_ptr(),
        None if b is None else r_out.data_ptr(), n.data_ptr(),
        stats.data_ptr(), rows, H, FWD_ROWS_PER_BLOCK, eps,
        int(out_dtype == torch.bfloat16), _cuda.stream_ptr(r))
    _cuda.check(code, entry)
    add_layernorm_fwd.launches += 1
    return r_out, n, stats


def _launch_bwd(dn, r_out, stats, weight, d_residual, branch_dtype):
    H = r_out.shape[-1]
    _check_width(H)
    _check("r_out", r_out, torch.float32, r_out.shape)
    _check("stats", stats, torch.float32, (2, *r_out.shape[:-1]))
    _check("weight", weight, torch.float32, (H,))
    if dn.dtype not in _N_DTYPES or dn.shape != r_out.shape:
        raise ValueError(f"dn is {dn.dtype} {tuple(dn.shape)}: the backward "
                         f"kernel reads bf16 or f32 {tuple(r_out.shape)}")
    if d_residual is not None:
        _check("d_residual", d_residual, torch.float32, r_out.shape)
    if branch_dtype not in (None, torch.bfloat16):
        raise ValueError(f"the backward kernel writes a bf16 branch "
                         f"gradient, not {branch_dtype}")
    x, st, w, g = (_aligned(t) for t in (r_out, stats, weight, dn))
    da = None if d_residual is None else _aligned(d_residual)
    rows = x.numel() // H
    dr = torch.empty_like(x)
    db = (None if branch_dtype is None
          else torch.empty(x.shape, dtype=branch_dtype, device=x.device))
    dweight = torch.empty(H, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dr, db, dweight.zero_()
    blocks = -(-rows // BWD_ROWS_PER_BLOCK)
    partial = torch.empty((blocks, H), dtype=torch.float32, device=x.device)
    entry = "splade_add_layernorm_bwd"
    code = getattr(_cuda.library(), entry)(
        g.data_ptr(), x.data_ptr(), st.data_ptr(), w.data_ptr(),
        None if da is None else da.data_ptr(), dr.data_ptr(),
        None if db is None else db.data_ptr(), partial.data_ptr(),
        dweight.data_ptr(), rows, H, BWD_ROWS_PER_BLOCK,
        int(g.dtype == torch.bfloat16), _cuda.stream_ptr(x))
    _cuda.check(code, entry)
    add_layernorm_bwd.launches += 1
    return dr, db, dweight


def add_layernorm_fwd(residual: torch.Tensor, branch: Optional[torch.Tensor],
                      weight: torch.Tensor, eps: float,
                      out_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(r', n, stats)``: the forward kernel on CUDA tensors (an f32
    residual, a bf16 branch or none, n in bf16 or f32), its plain version on
    CPU tensors."""
    if residual.is_cuda:
        return _launch_fwd(residual, branch, weight, eps, out_dtype)
    return add_layernorm_fwd_plain(residual, branch, weight, eps, out_dtype)


def add_layernorm_bwd(dn: torch.Tensor, r_out: torch.Tensor,
                      stats: torch.Tensor, weight: torch.Tensor,
                      d_residual: Optional[torch.Tensor],
                      branch_dtype: Optional[torch.dtype]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 torch.Tensor]:
    """``(dr, db, dweight)``: the backward kernels on CUDA tensors (one
    launch of the row pass and the weight's sum), the plain version on CPU
    tensors."""
    if r_out.is_cuda:
        return _launch_bwd(dn, r_out, stats, weight, d_residual, branch_dtype)
    return add_layernorm_bwd_plain(dn, r_out, stats, weight, d_residual,
                                   branch_dtype)


class _AddLayerNorm(torch.autograd.Function):
    """n, or (r', n) with a branch; the backward reads r', the row stats
    and the weight. Neither pass depends on the autocast state: the kernels
    take their dtypes as given and the plain versions turn autocast off."""

    @staticmethod
    def forward(ctx, residual, branch, weight, eps, out_dtype):
        r_out, n, stats = add_layernorm_fwd(residual, branch, weight, eps,
                                            out_dtype)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r_out, stats, weight)
        ctx.branch_dtype = None if branch is None else branch.dtype
        return n if branch is None else (r_out, n)

    @staticmethod
    def backward(ctx, *grads):
        r_out, stats, weight = ctx.saved_tensors
        d_residual, dn = ((None, grads[0]) if ctx.branch_dtype is None
                          else grads)
        if dn is None:  # n took no part in what is differentiated
            db = (None if d_residual is None or ctx.branch_dtype is None
                  else d_residual.to(ctx.branch_dtype))
            return d_residual, db, None, None, None
        dr, db, dweight = add_layernorm_bwd(dn, r_out, stats, weight,
                                            d_residual, ctx.branch_dtype)
        return dr, db, dweight, None, None


def add_layer_norm(residual: torch.Tensor, branch: Optional[torch.Tensor],
                   weight: torch.Tensor, eps: float, out_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(residual + branch, LayerNorm of it * weight in out_dtype)``, or
    ``(residual, its LayerNorm)`` with no branch; differentiable in the
    residual, the branch and the weight. The model calls it where
    ``fused_add_norm_applies``."""
    out = _AddLayerNorm.apply(residual, branch, weight, eps, out_dtype)
    return (residual, out) if branch is None else out


#: kernel launches since the last reset, added where a kernel is launched
#: and nowhere else (never for the plain versions or an empty batch); one
#: backward launch is the row pass and the weight's sum
add_layernorm_fwd.launches = 0
add_layernorm_bwd.launches = 0
