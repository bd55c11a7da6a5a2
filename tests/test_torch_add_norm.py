"""The fused residual add + LayerNorm pair (splade_tpu_torch.ops.add_norm)
on the CPU: its plain versions against autograd through the eager chain
they replace (values, the residual's, the branch's and the weight's
gradients) at the training micro-batches' rows, odd rows and a small width,
in each of the pair's forms and in f32 and f64; its autograd.Function's
plain path (``gradcheck`` in f64); the route rule; the launchers against a
recording library; and the encoder, whose (residual, pending) threading
leaves ``encode()`` and its gradients as they were. The kernels themselves
are held on the card by ``tests/test_torch_kernels_gpu.py``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from splade_tpu_torch.models import hf_port, modernbert
from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                ModernBertForMaskedLM)
from splade_tpu_torch.ops import add_norm as an

# more intra-op threads only contend with the other test workers
torch.set_num_threads(2)

EPS = 1e-5
BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64

#: form -> (branch dtype or None, residual dtype, n's dtype): a layer's site
#: under autocast, the final norm, the embedding's norm, and the f32 and f64
#: runs, which on the card keep the eager chain
FORMS = {"layer": (BF16, F32, BF16), "final": (BF16, F32, F32),
         "embedding": (None, F32, F32), "f32": (F32, F32, F32),
         "f64": (F64, F64, F64)}
#: (form, (B, S, H)): V33's packed micro-batch and MLM's at 768 for a
#: layer's site, an odd row count and a small width for every form
CASES = ([("layer", (144, 256, 768)), ("layer", (32, 512, 768))]
         + [(form, shape) for form in FORMS
            for shape in ((3, 37, 768), (5, 7, 64))])


def _case(shape, form, seed=0):
    """residual, branch (or None), weight near 1, and the cotangents of n
    and of r' in the dtypes autograd hands them."""
    branch_dtype, res_dtype, n_dtype = FORMS[form]
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, dtype=F64)
    r = (randn(*shape) * 4.0 + randn(*shape[:-1], 1)).to(res_dtype)
    b = None if branch_dtype is None else randn(*shape).to(branch_dtype)
    w = (1.0 + 0.1 * randn(shape[-1])).to(res_dtype)
    dn = randn(*shape).to(n_dtype)
    d_above = (randn(*shape) * 0.1).to(res_dtype)
    return r, b, w, dn, d_above


def _eager(r, b, w, out_dtype):
    """The chain the pair replaces: the add, LayerNorm in the residual's
    dtype, the cast the next product makes."""
    x = r if b is None else r + b
    return x, F.layer_norm(x, (x.shape[-1],), w, None, EPS).to(out_dtype)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _within_one_bf16_rounding(got, want):
    """|got - want| within one bf16 ulp of ``want`` (2^-7 of it)."""
    err = (got.double() - want.double()).abs()
    return bool((err <= want.double().abs() * 2.0 ** -7 + 1e-6).all())


@pytest.mark.parametrize("form,shape", CASES,
                         ids=[f"{f}-{'x'.join(map(str, s))}"
                              for f, s in CASES])
def test_plain_versions_are_the_eager_chain(form, shape):
    """r' bitwise the eager add; n and the row stats as the eager LayerNorm
    gives them (bf16: within one rounding of its cast); the backward's
    residual, branch and weight gradients as autograd through the chain
    gives them from the same cotangents (none on r' with no branch)."""
    branch_dtype, res_dtype, n_dtype = FORMS[form]
    r, b, w, dn, d_above = _case(shape, form)
    tol = 1e-10 if res_dtype == F64 else 2e-5

    r_out, n, stats = an.add_layernorm_fwd_plain(r, b, w, EPS, n_dtype)
    leaves = [t.detach().requires_grad_() for t in (r, w)
              ] + ([] if b is None else [b.detach().requires_grad_()])
    want_r, want_n = _eager(leaves[0], leaves[2] if b is not None else None,
                            leaves[1], n_dtype)
    assert r_out.dtype == res_dtype and n.dtype == n_dtype
    assert torch.equal(r_out, want_r.detach())
    if n_dtype == BF16:
        assert _within_one_bf16_rounding(n, want_n.detach())
    else:
        assert _rel(n, want_n.detach()) <= tol
    _, mean, rstd = torch.native_layer_norm(r_out, (shape[-1],), w, None,
                                            EPS)
    assert stats.shape == (2, *shape[:-1])
    assert _rel(stats[0], mean[..., 0]) <= tol
    assert _rel(stats[1], rstd[..., 0]) <= tol

    above = None if b is None else d_above
    outs, cots = (([want_n], [dn]) if b is None
                  else ([want_r, want_n], [d_above, dn]))
    grads = torch.autograd.grad(outs, leaves, cots)
    dr, db, dw = an.add_layernorm_bwd_plain(dn, r_out, stats, w, above,
                                            branch_dtype)
    assert dr.dtype == res_dtype and dw.dtype == w.dtype
    assert _rel(dr, grads[0]) <= tol
    assert _rel(dw, grads[1]) <= tol
    if b is None:
        assert db is None
    else:
        assert db.dtype == branch_dtype
        assert torch.equal(db, dr.to(branch_dtype))
        if branch_dtype == BF16:
            assert _within_one_bf16_rounding(db, grads[2])
        else:
            assert _rel(db, grads[2]) <= tol


@pytest.mark.parametrize("branch,uses", [
    (True, "both"), (True, "norm"), (True, "residual"), (False, "both"),
    (False, "norm")])
def test_gradcheck_through_the_plain_path(branch, uses):
    """The Function in f64 on the CPU (its plain versions), with or without
    a branch, r' used again or not (the final norm's r') and n used or not
    (with no branch the Function returns n alone)."""
    g = torch.Generator().manual_seed(2)
    r = torch.randn(3, 5, 8, generator=g, dtype=F64, requires_grad=True)
    b = torch.randn(3, 5, 8, generator=g, dtype=F64, requires_grad=True)
    w = (1 + 0.1 * torch.randn(8, generator=g, dtype=F64)).requires_grad_()
    c = torch.randn(3, 5, 8, generator=g, dtype=F64)

    def fn(r, b, w):
        res, n = an.add_layer_norm(r, b if branch else None, w, EPS, F64)
        if uses == "norm":
            return (n * c).sum()
        if uses == "residual":
            return (res * c).sum()
        return (n * c).sum() + (res * c.flip(-1)).sum()

    inputs = (r, b, w)
    assert torch.autograd.gradcheck(fn, inputs)
    if branch:
        assert type(an.add_layer_norm(r, b, w, EPS, F64)[1].grad_fn
                    ).__name__ == "_AddLayerNormBackward"


def _claim_cuda(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


def _autocast(monkeypatch, on, dtype=BF16):
    monkeypatch.setattr(torch, "is_autocast_enabled", lambda *a: on)
    monkeypatch.setattr(torch, "get_autocast_dtype", lambda *a: dtype)


def test_the_route_rule(monkeypatch):
    """The kernels take an f32 residual on the card whose norm feeds a bf16
    product (a bf16 branch, or bf16 autocast with no branch), a bias-free
    LayerNorm with an f32 weight over a width they are built for; nothing
    else: not the CPU, f32 or f64 runs, bf16 serving without autocast."""
    norm = nn.LayerNorm(768, eps=EPS, bias=False)
    r = torch.zeros(2, 3, 768)
    b = r.to(BF16)
    assert not an.fused_add_norm_applies(norm, r, b)  # CPU tensors
    _claim_cuda(monkeypatch)
    _autocast(monkeypatch, False)
    assert an.fused_add_norm_applies(norm, r, b)
    assert not an.fused_add_norm_applies(norm, r, None)  # f32 run
    assert not an.fused_add_norm_applies(norm, r, r)  # f32 branch
    assert not an.fused_add_norm_applies(norm, b, b)  # bf16 serving
    assert not an.fused_add_norm_applies(norm, r.double(), b)
    assert not an.fused_add_norm_applies(norm, r, b[:1])
    assert not an.fused_add_norm_applies(nn.Identity(), r, b)
    assert not an.fused_add_norm_applies(
        nn.LayerNorm(768, eps=EPS), r, b)  # with a bias
    assert not an.fused_add_norm_applies(
        nn.LayerNorm(768, eps=EPS, bias=False).to(BF16), r, b)
    narrow = nn.LayerNorm(64, eps=EPS, bias=False)
    assert not an.fused_add_norm_applies(narrow, r[..., :64], b[..., :64])
    for H in an.KERNEL_WIDTHS:
        wide = nn.LayerNorm(H, eps=EPS, bias=False)
        assert an.fused_add_norm_applies(wide, torch.zeros(2, H),
                                         torch.zeros(2, H, dtype=BF16))
    _autocast(monkeypatch, True)
    assert an.fused_add_norm_applies(norm, r, None)  # the embedding's norm
    _autocast(monkeypatch, True, torch.float16)
    assert not an.fused_add_norm_applies(norm, r, None)


class _RecordingLibrary:
    """Stands in for the built kernel library: every entry records its
    arguments and reports success, so the launchers run on CPU tensors."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0
        return call


@pytest.fixture
def recording(monkeypatch):
    from splade_tpu_torch.ops import _cuda

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(an.add_layernorm_fwd, "launches", 0)
    monkeypatch.setattr(an.add_layernorm_bwd, "launches", 0)
    return lib


def _counts():
    return an.add_layernorm_fwd.launches, an.add_layernorm_bwd.launches


@pytest.mark.parametrize("form", ["layer", "final", "embedding"])
def test_launchers_count_where_they_launch_and_nowhere_else(recording, form):
    """Each launcher adds one to its count after its C entry returned,
    never for the plain versions or an empty batch; the entries get the
    tensors as they are (no copies of contiguous, aligned ones), null for a
    missing branch, r' and gradient from above, then rows, H, the rows a
    block, eps and whether n (dn) is bf16."""
    from splade_tpu_torch.ops import _cuda

    branch_dtype, _, n_dtype = FORMS[form]
    B, S, H = 3, 37, 768
    r, b, w, dn, d_above = _case((B, S, H), form)
    an.add_layernorm_fwd(r, b, w, EPS, n_dtype)
    an.add_layernorm_bwd(dn, r, torch.zeros(2, B, S), w, None, branch_dtype)
    assert recording.calls == [] and _counts() == (0, 0)
    empty = an._launch_fwd(r[:0], None if b is None else b[:0], w, EPS,
                           n_dtype)
    assert empty[1].shape == (0, S, H) and empty[2].shape == (2, 0, S)
    assert recording.calls == [] and _counts() == (0, 0)

    r_out, n, stats = an._launch_fwd(r, b, w, EPS, n_dtype)
    assert n.shape == (B, S, H) and n.dtype == n_dtype
    assert stats.shape == (2, B, S) and stats.dtype == F32
    assert (r_out is r) == (b is None)
    assert _counts() == (1, 0)
    above = None if b is None else d_above
    dr, db, dw = an._launch_bwd(dn, r_out, stats, w, above, branch_dtype)
    assert dr.shape == (B, S, H) and dr.dtype == F32
    assert (db is None) == (b is None) and dw.shape == (H,)
    assert _counts() == (1, 1)
    (fwd_entry, fa), (bwd_entry, ba) = recording.calls
    assert fwd_entry == "splade_add_layernorm_fwd"
    assert fa[0] == r.data_ptr() and fa[2] == w.data_ptr()
    assert fa[1] == (None if b is None else b.data_ptr())
    assert fa[3] == (None if b is None else r_out.data_ptr())
    assert fa[4:6] == (n.data_ptr(), stats.data_ptr())
    assert fa[6:] == (B * S, H, an.FWD_ROWS_PER_BLOCK, EPS,
                      int(n_dtype == BF16), 0)
    assert bwd_entry == "splade_add_layernorm_bwd"
    assert ba[:4] == (dn.data_ptr(), r_out.data_ptr(), stats.data_ptr(),
                      w.data_ptr())
    assert ba[4] == (None if above is None else above.data_ptr())
    assert ba[5] == dr.data_ptr() and ba[8] == dw.data_ptr()
    assert ba[6] == (None if db is None else db.data_ptr())
    assert ba[9:] == (B * S, H, an.BWD_ROWS_PER_BLOCK, int(n_dtype == BF16),
                      0)
    for entry, args in recording.calls:
        assert len(_cuda.SIGNATURES[entry]) == len(args)


def _offset(t, elements=1):
    """``t``'s values in a contiguous view that starts ``elements`` into
    its storage: off the 16-byte alignment the kernels' vector loads need."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype)
    view = flat[elements:].view(t.shape)
    view.copy_(t)
    return view


def test_launchers_hand_the_kernels_aligned_contiguous_tensors(recording):
    """Inputs that are contiguous views at a storage offset, or strided
    views, reach the entries as aligned contiguous copies of the same
    values."""
    r, b, w, dn, d_above = _case((2, 5, 256), "layer")
    views = [_offset(t) for t in (r, b, w)]
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    an._launch_fwd(*views, EPS, BF16)
    strided = dn.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    an._launch_bwd(strided, r, torch.zeros(2, 2, 5), w, _offset(d_above),
                   BF16)
    (_, fa), (_, ba) = recording.calls
    for ptr in (*fa[:3], *ba[:5]):
        assert ptr % 16 == 0
    assert set(fa[:3]).isdisjoint(v.data_ptr() for v in views)
    assert ba[0] != strided.data_ptr()
    assert torch.equal(an._aligned(views[0]), r)
    assert torch.equal(an._aligned(strided), dn)


def test_wrappers_refuse_what_the_kernels_do_not_take(recording):
    r, b, w, dn, d_above = _case((2, 5, 768), "layer")
    stats = torch.zeros(2, 2, 5)
    with pytest.raises(ValueError, match="width 64"):
        an._launch_fwd(r[..., :64], b[..., :64], w[:64], EPS, BF16)
    with pytest.raises(ValueError, match="residual"):
        an._launch_fwd(r.double(), b, w, EPS, BF16)
    with pytest.raises(ValueError, match="branch"):
        an._launch_fwd(r, b.float(), w, EPS, BF16)
    with pytest.raises(ValueError, match="branch"):
        an._launch_fwd(r, b[:1], w, EPS, BF16)
    with pytest.raises(ValueError, match="weight"):
        an._launch_fwd(r, b, w.to(BF16), EPS, BF16)
    with pytest.raises(ValueError, match="writes bf16 or f32"):
        an._launch_fwd(r, b, w, EPS, F64)
    with pytest.raises(ValueError, match="dn"):
        an._launch_bwd(dn.double(), r, stats, w, d_above, BF16)
    with pytest.raises(ValueError, match="stats"):
        an._launch_bwd(dn, r, stats[:, :1], w, d_above, BF16)
    with pytest.raises(ValueError, match="d_residual"):
        an._launch_bwd(dn, r, stats, w, d_above.to(BF16), BF16)
    with pytest.raises(ValueError, match="bf16 branch gradient"):
        an._launch_bwd(dn, r, stats, w, d_above, F32)
    assert recording.calls == []


def _old_layer_forward(self, x, pending, attn_bias, cos, sin, seg=None):
    """``ModernBertLayer.forward`` as it was before the fused add + norm:
    both residual adds inside the layer, nothing left pending."""
    assert pending is None
    x = x + self.attn(self.attn_norm(x), attn_bias, cos, sin, seg)
    return x + self.mlp(self.mlp_norm(x)), None


def _encode_and_grads(model, ids, mask):
    model.zero_grad()
    h = model.encode(ids, mask)
    (h * torch.linspace(-1, 1, h.shape[-1])).sum().backward()
    return h.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}


@pytest.mark.parametrize("impl", ["sdpa", "splash"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("function", [False, True],
                         ids=["route", "function"])
def test_encode_on_the_cpu_is_unchanged(monkeypatch, impl, remat, function):
    """A tiny encoder on the CPU: its output and every parameter's gradient
    bitwise what the layers gave before the (residual, pending) threading
    when each site keeps the eager chain (as on the CPU), and within f32
    rounding when every LayerNorm site takes the autograd.Function (its
    plain versions here), once a site (the embedding's norm and 2 L residual
    adds) and again inside the layers under recompute; the launch counts
    stay 0; the state dict's names are the HF ones."""
    cfg = ModernBertConfig.tiny(attention_impl=impl, remat=remat)
    torch.manual_seed(0)
    model = ModernBertForMaskedLM(cfg)
    assert set(model.state_dict()) == set(hf_port.hf_names(cfg))
    g = torch.Generator().manual_seed(3)
    B, S = 3, 16
    ids = torch.randint(0, cfg.vocab_size - 1, (B, S), generator=g)
    mask = torch.ones(B, S, dtype=torch.int64)
    mask[1, 11:] = 0
    monkeypatch.setattr(an.add_layernorm_fwd, "launches", 0)
    monkeypatch.setattr(an.add_layernorm_bwd, "launches", 0)
    calls = []
    real = modernbert.add_layer_norm

    def recording(residual, branch, weight, eps, out_dtype):
        calls.append((branch is not None, out_dtype))
        return real(residual, branch, weight, eps, out_dtype)

    monkeypatch.setattr(modernbert, "add_layer_norm", recording)
    if function:
        monkeypatch.setattr(modernbert, "fused_add_norm_applies",
                            lambda norm, r, b: isinstance(norm,
                                                          nn.LayerNorm))
    got = _encode_and_grads(model, ids, mask)
    L = cfg.num_hidden_layers
    inner = [(True, F32)] * (2 * L - 1)
    want_calls = ([(False, F32)] + inner + [(True, F32)]
                  + (inner if remat else [])) if function else []
    assert sorted(calls) == sorted(want_calls)
    monkeypatch.setattr(modernbert.ModernBertLayer, "forward",
                        _old_layer_forward)
    want = _encode_and_grads(model, ids, mask)
    assert got[1].keys() == want[1].keys() and len(want[1]) > 10
    if function:
        assert _rel(got[0], want[0]) <= 1e-5
        for name, grad in want[1].items():
            assert _rel(got[1][name], grad) <= 1e-4, name
    else:
        assert torch.equal(got[0], want[0])
        for name, grad in want[1].items():
            assert torch.equal(got[1][name], grad), name
    assert _counts() == (0, 0)
