"""The RoPE kernel pair of the splash route (splade_tpu_torch.ops.rope) on
the CPU: its plain versions against the model's ``apply_rope`` chain, its
autograd.Function's plain path (values and gradients bitwise the chain's
in f32, ``gradcheck`` in f64), the route rule, the launchers against a
recording library, and the model on the splash route, which on the CPU
computes what it computed before. The kernels themselves are held on the
card by ``tests/test_torch_kernels_gpu.py``.
"""

import pytest
import torch

from splade_tpu_torch.models import modernbert
from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                ModernBertForMaskedLM,
                                                apply_rope, rope_cos_sin)
from splade_tpu_torch.ops import rope

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

TABLES = ["shared", "packed"]


def _case(B, S, N, D, tables, dtype=torch.float32, seed=0):
    """A QKV product [B, S, 3, N, D] in ``dtype`` and f32 tables, [S, D]
    (shared) or [B, S, D] gathered by random positions (packed)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3, N, D, generator=g).to(dtype)
    cos, sin = rope_cos_sin(S, D, 10000.0)
    if tables == "packed":
        pos = torch.randint(0, S, (B, S), generator=g)
        cos, sin = cos[pos], sin[pos]
    return qkv, cos, sin


def _chain(qkv, cos, sin):
    """The model's plain rotation: q, k, v cut from the product, q and k
    rotated."""
    q, k, v = qkv.unbind(2)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _cotangents(shape, seed=1):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for _ in range(3)]


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_is_the_chain_rounded_once(tables, dtype):
    """The forward's plain version is the chain's f32 result rounded once
    to the product's dtype: in bf16, the cast the attention made of it."""
    qkv, cos, sin = _case(3, 11, 2, 16, tables, dtype)
    q, k, _ = _chain(qkv, cos, sin)
    got = rope.rope_qkv_fwd_plain(qkv, cos, sin)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got[0], q.to(dtype))
    assert torch.equal(got[1], k.to(dtype))


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("remat", [False, True])
def test_function_values_and_gradients_equal_the_chain(tables, remat):
    """Through autograd in f32, with and without layer recompute: q, k and
    v and the product's gradient bitwise the chain's; v stays a view of
    the product."""
    from torch.utils.checkpoint import checkpoint

    qkv, cos, sin = _case(2, 9, 3, 8, tables)
    w = _cotangents((2, 9, 3, 8))

    def loss(fn, x):
        def run(x):
            return sum((t * c).sum() for t, c in zip(fn(x, cos, sin), w))
        return checkpoint(run, x, use_reentrant=False) if remat else run(x)

    want_leaf = qkv.clone().requires_grad_()
    got_leaf = qkv.clone().requires_grad_()
    want = _chain(want_leaf, cos, sin)
    got = rope.rope_qkv(got_leaf, cos, sin)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[2]._base is got_leaf
    assert type(got[0].grad_fn).__name__ == "_RopeQKVBackward"
    loss(_chain, want_leaf).backward()
    loss(rope.rope_qkv, got_leaf).backward()
    assert torch.equal(got_leaf.grad, want_leaf.grad)


@pytest.mark.parametrize("tables", TABLES)
def test_gradcheck_through_the_plain_path(tables):
    qkv, cos, sin = _case(2, 5, 2, 4, tables, torch.float64)
    leaf = qkv.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: rope.rope_qkv(x, cos.double(), sin.double()), (leaf,))


@pytest.mark.parametrize("tables", TABLES)
def test_plain_backward_in_bf16_rounds_once(tables):
    """The backward's plain version in bf16: dq and dk rotated back within
    one bf16 rounding of the f64 rotation, dv copied into its slot."""
    _, cos, sin = _case(3, 13, 2, 64, tables)
    dq, dk, dv = (t.to(torch.bfloat16) for t in _cotangents((3, 13, 2, 64)))
    got = rope.rope_qkv_bwd_plain(dq, dk, dv, cos, sin, torch.bfloat16)
    want = rope.rope_qkv_bwd_plain(dq.double(), dk.double(), dv.double(),
                                   cos.double(), sin.double(), torch.float64)
    assert got.shape == (3, 13, 3, 2, 64) and got.dtype == torch.bfloat16
    assert got.is_contiguous()
    err = (got.double() - want).abs()
    assert bool((err <= want.abs() * 2.0 ** -8 + 1e-6).all())
    assert torch.equal(got[:, :, 2], dv)
    # the f64 rotation is the transpose of the forward's: <R x, g> = <x, R^T g>
    qkv, _, _ = _case(3, 13, 2, 64, tables, torch.float64)
    fwd = rope.rope_qkv_fwd_plain(qkv, cos.double(), sin.double())
    lhs = (fwd[0] * dq.double()).sum() + (fwd[1] * dk.double()).sum()
    rhs = (qkv[:, :, :2] * want[:, :, :2]).sum()
    assert abs(float(lhs - rhs)) <= 1e-9 * float(lhs.abs())


def _claim_cuda(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


def test_the_route_rule(monkeypatch):
    """The kernels take a bf16 product on the card with heads of 64 and
    f32 tables that need no gradient; nothing else."""
    qkv, cos, sin = _case(2, 8, 2, 64, "shared", torch.bfloat16)
    assert not rope.fused_rope_applies(qkv, cos, sin)  # a CPU tensor
    _claim_cuda(monkeypatch)
    assert rope.fused_rope_applies(qkv, cos, sin)
    assert not rope.fused_rope_applies(qkv.float(), cos, sin)
    assert not rope.fused_rope_applies(qkv, cos.bfloat16(), sin.bfloat16())
    assert not rope.fused_rope_applies(qkv[..., :32], cos[:, :32],
                                       sin[:, :32])
    assert not rope.fused_rope_applies(qkv, cos.requires_grad_(), sin)


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


@pytest.mark.parametrize("tables", TABLES)
def test_launchers_count_where_they_launch_and_nowhere_else(monkeypatch,
                                                            tables):
    """Each launcher adds one to its count after the C entry returned,
    never for an empty batch or the plain versions; the entries get the
    product as it is, the tables' batch stride (0 for shared tables), the
    gradients' strides as they are (a strided dv view is not copied), then
    B, S, N, D."""
    from splade_tpu_torch.ops import _cuda

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(rope.rope_qkv_fwd, "launches", 0)
    monkeypatch.setattr(rope.rope_qkv_bwd, "launches", 0)
    count = lambda: (rope.rope_qkv_fwd.launches, rope.rope_qkv_bwd.launches)
    B, S, N, D = 3, 40, 2, 64
    qkv, cos, sin = _case(B, S, N, D, tables, torch.bfloat16)
    batch = 0 if tables == "shared" else S * D

    # the plain versions on CPU tensors count nothing
    rope.rope_qkv_fwd(qkv, cos, sin)
    assert lib.calls == [] and count() == (0, 0)
    empty = rope._launch_fwd(qkv[:0], cos[:0] if cos.dim() == 3 else cos,
                             sin[:0] if sin.dim() == 3 else sin)
    assert empty.shape == (2, 0, S, N, D)
    assert lib.calls == [] and count() == (0, 0)

    out = rope._launch_fwd(qkv, cos, sin)
    assert out.shape == (2, B, S, N, D) and out.dtype == torch.bfloat16
    assert count() == (1, 0)
    dq, dk = out[0], out[1].float()       # dk cast to bf16 by the wrapper
    dv = qkv[:, :, 2]                     # a strided view, read as it is
    dqkv = rope._launch_bwd(dq, dk, dv, cos, sin, torch.bfloat16)
    assert dqkv.shape == (B, S, 3, N, D) and dqkv.dtype == torch.bfloat16
    assert count() == (1, 1)
    (fwd_entry, fwd_args), (bwd_entry, bwd_args) = lib.calls
    assert fwd_entry == "splade_rope_qkv_fwd"
    assert fwd_args[0] == qkv.data_ptr() and fwd_args[3] == out.data_ptr()
    assert fwd_args[4:] == (B, S, N, D, batch, 0)
    assert bwd_entry == "splade_rope_qkv_bwd"
    assert bwd_args[0] == dq.data_ptr() and bwd_args[2] == dv.data_ptr()
    assert bwd_args[5] == dqkv.data_ptr()
    row, fused = S * N * D, S * 3 * N * D
    assert bwd_args[6:] == (row, N * D, D, row, N * D, D,
                            fused, 3 * N * D, D, B, S, N, D, batch, 0)
    for entry, args in lib.calls:
        assert len(_cuda.SIGNATURES[entry]) == len(args)


def _offset(t, elements=1):
    """``t``'s values in a contiguous view that starts ``elements`` into
    its storage: off the 16-byte alignment the kernels' vector loads need."""
    flat = torch.empty(t.numel() + elements, dtype=t.dtype)
    view = flat[elements:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("tables", TABLES)
def test_launchers_hand_the_kernels_aligned_addresses(monkeypatch, tables):
    """A product, tables or gradients that are contiguous views at a
    storage offset reach the entries as aligned copies of the same values;
    aligned ones reach them as they are."""
    from splade_tpu_torch.ops import _cuda

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(rope.rope_qkv_fwd, "launches", 0)
    monkeypatch.setattr(rope.rope_qkv_bwd, "launches", 0)
    qkv, cos, sin = _case(2, 8, 2, 64, tables, torch.bfloat16)
    dq, dk, dv = (t.to(torch.bfloat16) for t in _cotangents((2, 8, 2, 64)))
    views = [_offset(t) for t in (qkv, cos, sin, dq, dk, dv)]
    assert all(v.is_contiguous() and v.data_ptr() % 16 for v in views)
    rope._launch_fwd(*views[:3])
    rope._launch_bwd(*views[3:], views[1], views[2], torch.bfloat16)
    (_, fwd_args), (_, bwd_args) = lib.calls
    # fwd: qkv, cos, sin; bwd: dq, dk, dv, cos, sin
    for ptr in (*fwd_args[:3], *bwd_args[:5]):
        assert ptr % 16 == 0
    assert {fwd_args[0], fwd_args[1], fwd_args[2]}.isdisjoint(
        v.data_ptr() for v in views)
    assert set(bwd_args[:5]).isdisjoint(v.data_ptr() for v in views)
    lib.calls.clear()
    rope._launch_fwd(qkv, cos, sin)
    rope._launch_bwd(dq, dk, dv, cos, sin, torch.bfloat16)
    (_, fwd_args), (_, bwd_args) = lib.calls
    assert fwd_args[:3] == (qkv.data_ptr(), cos.data_ptr(), sin.data_ptr())
    assert bwd_args[:5] == (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            cos.data_ptr(), sin.data_ptr())
    # the copies hold the same values
    assert torch.equal(rope._aligned(views[0]), qkv)
    assert torch.equal(rope._grad("dq", views[3], dq.shape), dq)


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    from splade_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "library", _RecordingLibrary)
    qkv, cos, sin = _case(2, 8, 2, 64, "shared", torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 32"):
        rope._launch_fwd(qkv[..., :32], cos[:, :32], sin[:, :32])
    with pytest.raises(ValueError, match="take bf16"):
        rope._launch_fwd(qkv.float(), cos, sin)
    with pytest.raises(ValueError, match=r"\[B, S, 3, N, D\]"):
        rope._launch_fwd(qkv[:, :, :2], cos, sin)
    with pytest.raises(ValueError, match="cos"):
        rope._launch_fwd(qkv, cos[:4], sin[:4])
    g = qkv[:, :, 0]
    with pytest.raises(ValueError, match="writes bf16"):
        rope._launch_bwd(g, g, g, cos, sin, torch.float32)
    with pytest.raises(ValueError, match="dv"):
        rope._launch_bwd(g, g, g[:1], cos, sin, torch.bfloat16)


def _old_attention_forward(self, x, attn_bias, cos, sin, seg=None):
    """``ModernBertAttention.forward`` as it was before the RoPE kernels:
    the chain on every route."""
    B, S, H = x.shape
    qkv = self.Wqkv(x).view(B, S, 3, self.n_heads, self.head_dim)
    q, k, v = _chain(qkv, cos, sin)
    if seg is not None:
        out = modernbert.splash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), seg,
            self.half_window)
        return self.Wo(out.reshape(B, S, H))
    raise AssertionError("only the splash route is compared here")


def _encode_and_grads(model, ids, mask, positions, segments):
    model.zero_grad()
    h = model.encode(ids, mask, positions, segments)
    (h * torch.linspace(-1, 1, h.shape[-1])).sum().backward()
    return h.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("function", [False, True],
                         ids=["route", "function"])
def test_splash_route_encode_on_the_cpu_is_unchanged(monkeypatch, tables,
                                                     remat, function):
    """A tiny encoder on the splash route, on the CPU: its output and every
    parameter's gradient bitwise what the chain gave before, whether the
    route keeps the chain (as on the CPU) or takes the autograd.Function
    (its plain versions here); the launch counts stay 0."""
    cfg = ModernBertConfig.tiny(attention_impl="splash", remat=remat)
    torch.manual_seed(0)
    model = ModernBertForMaskedLM(cfg)
    g = torch.Generator().manual_seed(3)
    B, S = 3, 16
    ids = torch.randint(0, cfg.vocab_size - 1, (B, S), generator=g)
    mask = torch.ones(B, S, dtype=torch.int64)
    mask[1, 11:] = 0
    positions = segments = None
    if tables == "packed":
        positions = torch.arange(S).remainder(8).expand(B, S)
        segments = (torch.arange(S) // 8).expand(B, S)
    monkeypatch.setattr(rope.rope_qkv_fwd, "launches", 0)
    monkeypatch.setattr(rope.rope_qkv_bwd, "launches", 0)
    calls = []
    real = modernbert.rope_qkv

    def recording(qkv, cos, sin):
        calls.append(tuple(cos.shape))
        return real(qkv, cos, sin)

    monkeypatch.setattr(modernbert, "rope_qkv", recording)
    if function:
        monkeypatch.setattr(modernbert, "fused_rope_applies",
                            lambda qkv, cos, sin: True)
    got = _encode_and_grads(model, ids, mask, positions, segments)
    want_calls = ([((S, cfg.head_dim) if tables == "shared"
                    else (B, S, cfg.head_dim))]
                  * cfg.num_hidden_layers * (2 if remat else 1)
                  if function else [])
    assert calls == want_calls
    monkeypatch.setattr(modernbert.ModernBertAttention, "forward",
                        _old_attention_forward)
    want = _encode_and_grads(model, ids, mask, positions, segments)
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys() and len(want[1]) > 10
    for name, grad in want[1].items():
        assert torch.equal(got[1][name], grad), name
    assert (rope.rope_qkv_fwd.launches, rope.rope_qkv_bwd.launches) == (0, 0)


def test_sdpa_route_keeps_the_chain(monkeypatch):
    """The sdpa route never reaches the kernels' Function, whatever the
    rule says."""
    monkeypatch.setattr(modernbert, "fused_rope_applies",
                        lambda qkv, cos, sin: True)
    monkeypatch.setattr(modernbert, "rope_qkv", lambda *a: pytest.fail(
        "the sdpa route took the RoPE kernels"))
    cfg = ModernBertConfig.tiny(num_hidden_layers=2)
    model = ModernBertForMaskedLM(cfg)
    ids = torch.zeros(2, 8, dtype=torch.int64)
    model.encode(ids, torch.ones_like(ids)).sum().backward()
