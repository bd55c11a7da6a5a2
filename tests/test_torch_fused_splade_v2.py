"""The port's row-blocked SPLADE pool (splade_tpu_torch.ops.fused_splade_v2)
against splade_tpu's ``fused_splade_pool_v2`` on the same numpy inputs.

On a CPU tensor the port runs its plain versions, forward and backward;
JAX's runs the Pallas kernels (custom VJP) in interpret mode. Both are f32
here: values agree within 1e-5 and gradients within the JAX package's own
1e-4 (rtol, atol 1e-5). Against the port's per-row family the plain
versions differ by the blocking of one f32 matmul only (1e-6); on the card
the two kernel families are bitwise equal (tests/test_torch_kernels_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.ops.fused_splade_v2 import fused_splade_pool_v2 as jax_v2
from splade_tpu_torch.ops.fused_splade import (
    dh_splits, dh_vocab_splits_v2, fold_cotangent,
    fused_splade_bwd_match_plain, fused_splade_bwd_plain,
    fused_splade_gather_dh_plain, fused_splade_pool, fused_splade_pool_plain,
    fwd_shared_bytes, match_shared_bytes, pick_row_block, vocab_ranges)
from splade_tpu_torch.ops.fused_splade_v2 import (
    fused_splade_bwd_dh_v2, fused_splade_bwd_dw_v2, fused_splade_bwd_match_v2,
    fused_splade_bwd_match_v2_plain, fused_splade_bwd_v2_plain,
    fused_splade_maxima_v2, fused_splade_pool_v2, fused_splade_pool_v2_plain)

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _case(seed, B, S=16, H=32, V=300):
    """tests/test_fused_splade.py's kind of inputs: V not a tile multiple,
    ragged lengths, the last row fully padded."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = rng.normal(size=(V, H)).astype(np.float32) * 0.3
    bias = rng.normal(size=(V,)).astype(np.float32) * 0.1
    lengths = rng.integers(S // 2, S + 1, size=(B,))
    lengths[-1] = 0
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    return h, w, bias, mask


def _jax_out_and_grads(h, w, bias, mask, row_block):
    def loss(h_, w_, b_):
        p, tw = jax_v2(h_, w_, b_, jnp.asarray(mask), 128, row_block)
        return jnp.sum(jnp.sin(p) * p), (p, tw)

    (_, (p, tw)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias))
    return np.asarray(p), np.asarray(tw), [np.asarray(g) for g in grads]


def _port_out_and_grads(pool, h, w, bias, mask):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (h, w, bias)]
    p, tw = pool(*leaves, torch.from_numpy(mask))
    assert not tw.requires_grad  # token weights carry no gradient
    (torch.sin(p) * p).sum().backward()
    return (p.detach().numpy(), tw.numpy(),
            [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("B,row_block,resolved", [
    (3, 0, 1),    # 8, 4 and 2 do not divide 3: one row a block
    (8, 4, 4),    # explicit
    (8, 8, 8),    # explicit, one block
])
def test_v2_forward_and_gradient_match_jax_pallas(B, row_block, resolved):
    """pooled, token weights, dh, dW and dbias against the Pallas kernels
    of fused_splade_pool_v2 in interpret mode; the fully padded row pools
    to 0 and gets a zero, finite gradient."""
    case = _case(B * 10 + row_block, B)
    assert (row_block or pick_row_block(B)) == resolved
    j_p, j_tw, j_g = _jax_out_and_grads(*case, row_block)
    t_p, t_tw, t_g = _port_out_and_grads(
        lambda *a: fused_splade_pool_v2(*a, row_block), *case)
    np.testing.assert_allclose(t_p, j_p, **TOL)
    np.testing.assert_allclose(t_tw, j_tw, **TOL)
    for g, j, name in zip(t_g, j_g, ("dh", "dw", "dbias")):
        np.testing.assert_allclose(g, j, **GRAD_TOL, err_msg=name)
    assert np.all(t_p[-1] == 0) and np.all(t_tw[-1] == 0)
    assert np.isfinite(t_g[0]).all() and np.abs(t_g[0][-1]).max() == 0.0


@pytest.mark.parametrize("B,row_block", [(3, 0), (6, 3), (8, 0), (8, 2)])
def test_v2_equals_the_per_row_family(B, row_block):
    """Same function as fused_splade_pool: outputs and gradients agree to
    1e-6 (the plain versions differ only by how one f32 matmul is blocked;
    the kernels are bitwise equal on the card)."""
    case = _case(B + row_block, B)
    p1, tw1, g1 = _port_out_and_grads(fused_splade_pool, *case)
    p2, tw2, g2 = _port_out_and_grads(
        lambda *a: fused_splade_pool_v2(*a, row_block), *case)
    np.testing.assert_allclose(p2, p1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tw2, tw1, rtol=1e-6, atol=1e-6)
    for a, b in zip(g2, g1):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # either family's backward recomputes from the other's maxima within
    # the same tolerance
    h, w, bias, mask = (torch.from_numpy(x) for x in case)
    m1, _ = fused_splade_pool_plain(h, w, bias, mask)
    m2, _ = fused_splade_pool_v2_plain(h, w, bias, mask, row_block)
    torch.testing.assert_close(m2, m1, rtol=1e-6, atol=1e-6)


def test_v2_ties_get_duplicate_gradient_as_jax():
    h, w, bias, mask = _case(3, 4)
    h[0, 1] = h[0, 0]  # exact ties in row 0
    mask[0, :2] = 1
    _, _, want = _jax_out_and_grads(h, w, bias, mask, 2)
    _, _, got = _port_out_and_grads(
        lambda *a: fused_splade_pool_v2(*a, 2), h, w, bias, mask)
    for g, j, name in zip(got, want, ("dh", "dw", "dbias")):
        np.testing.assert_allclose(g, j, **GRAD_TOL, err_msg=name)
    np.testing.assert_array_equal(got[0][0, 0], got[0][0, 1])


@pytest.mark.parametrize("B,row_block", [(6, 4), (3, 2), (8, 3), (4, -1)])
def test_v2_refuses_a_row_block_that_does_not_divide_the_batch(B, row_block):
    """As fused_splade_v2.py:128-134: the tail rows would go uncomputed."""
    h, w, bias, mask = (torch.from_numpy(x) for x in _case(0, B))
    with pytest.raises(ValueError, match="must divide batch"):
        fused_splade_pool_v2(h, w, bias, mask, row_block)
    if row_block > 0:
        with pytest.raises(ValueError, match="must divide batch"):
            jax_v2(jnp.asarray(h.numpy()), jnp.asarray(w.numpy()),
                   jnp.asarray(bias.numpy()), jnp.asarray(mask.numpy()), 128,
                   row_block)


def test_v2_wrappers_on_cpu_are_the_plain_version():
    """On CPU tensors the wrappers return the plain versions and count no
    launch; gradients come back in the dtypes of h and w; bias may be
    None."""
    h, w, bias, mask = (torch.from_numpy(x) for x in _case(5, 4))
    counters = (fused_splade_pool_v2, fused_splade_bwd_dh_v2,
                fused_splade_bwd_dw_v2)
    before = [f.launches for f in counters]
    m, pos = fused_splade_maxima_v2(h, w, bias, mask, 2)
    m_p, pos_p = fused_splade_pool_v2_plain(h, w, bias, mask, 2)
    assert torch.equal(m, m_p) and torch.equal(pos, pos_p)
    g_pre = fold_cotangent(torch.ones_like(m), m)
    dh, dw = fused_splade_bwd_v2_plain(h, w, bias, mask, m, g_pre, 2)
    assert torch.equal(fused_splade_bwd_dh_v2(h, w, bias, mask, m, g_pre, 2),
                       dh)
    assert torch.equal(fused_splade_bwd_dw_v2(h, w, bias, mask, m, g_pre, 2),
                       dw)
    assert [f.launches for f in counters] == before
    # the per-row plain backward agrees from the same maxima's function
    m1, _ = fused_splade_pool_plain(h, w, bias, mask)
    dh1, dw1 = fused_splade_bwd_plain(h, w, bias, mask, m1,
                                      fold_cotangent(torch.ones_like(m1), m1))
    torch.testing.assert_close(dh, dh1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, dw1, rtol=1e-5, atol=1e-6)
    hb = h.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    pooled, tw = fused_splade_pool_v2(hb, wb, None, mask)
    pooled.sum().backward()
    assert hb.grad.dtype == wb.grad.dtype == torch.bfloat16
    assert pooled.dtype == tw.dtype == torch.float32


@pytest.mark.parametrize("B,S,V,splits", [
    (128, 256, 50000, 4),   # the document batch: 1,024 word rows
    (64, 64, 50000, 16),    # the query batch: 128 word rows, the most splits
    (512, 256, 50000, 1),   # 4,096 word rows: enough blocks without a split
    (16, 512, 50000, 16),
    (3, 40, 100, 4),        # never more ranges than 32-column runs
])
def test_v2_dh_vocab_splits_and_shared_memory(B, S, V, splits):
    """The dh gather splits the vocabulary only where word rows are few,
    its ranges cover the vocabulary in whole 32-column runs, in order; the
    forward and the match pass, both on the walk, fit two blocks an SM at
    every row block the family picks, at any hidden width (the walk streams
    it: 2048 runs); the backward refuses a sequence whose 16-row groups the
    match pass cannot list, never a hidden width: past 768 the gathers cut
    it into slices."""
    from splade_tpu_torch.ops import fused_splade

    assert dh_vocab_splits_v2(B, S, V) == splits
    ranges = vocab_ranges(V, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == V
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(vb % 32 == 0 for vb, _ in ranges)
    for rb in (1, 2, 4, 8):
        # two blocks an SM at the training shapes
        assert 2 * (fwd_shared_bytes(S, rb) + 1024) <= 233_472
        assert 2 * (match_shared_bytes(S, rb) + 1024) <= 233_472
    shaped = lambda *shape: torch.zeros(()).expand(*shape)  # no storage
    rb = pick_row_block(B)
    for backward in (False, True):
        assert fused_splade._check(shaped(B, S, 768), rb, backward) == rb
        assert fused_splade._check(shaped(B, 4, 2048), rb, backward) == rb
    assert fused_splade._check(shaped(B, 4, 1024), rb, True) == rb
    assert dh_splits(B, S, 768, V) == (1, splits)
    assert dh_splits(B, S, 1024, V) == (2, splits)
    # the match pass lists every 16-row group of its row block
    with pytest.raises(ValueError, match="match pass"):
        fused_splade._check(shaped(B, 1 << 17, 768), B, True)


@pytest.mark.parametrize("S,rb,need", [
    (1, 1, 83_976),
    (256, 8, 88_576),      # the document batch at the default row block
    (64, 16, 92_160),      # what the per-row family owns a block at S=64
    (512, 193, 231_680),   # the most that fits beside the static 128
    (512, 194, 232_448),   # one block's limit, but not with the static part
    (512, 195, 233_216),
    (512, 256, 280_064),
])
def test_v2_forward_shared_memory_and_its_refusal(S, rb, need):
    """The forward's shared memory (the walk's ring of 81,920 bytes, a row
    of 128 column keys a batch row, two rows of 128 row maxima, 128 biases
    and one int2 a 16-row group) at sequence length S and row block rb:
    ``_check`` takes a row block whose layout, beside the kernel's 128
    bytes of static shared memory, fits one block's 232,448 bytes, whatever
    the hidden width, and refuses a larger one with a message that says
    why."""
    from splade_tpu_torch.ops import fused_splade

    assert fwd_shared_bytes(S, rb) == need
    h = torch.zeros(()).expand(rb, S, 2048)  # no storage
    total = need + fused_splade.STATIC_SHARED_BYTES
    if total <= fused_splade.MAX_SHARED_BYTES:
        assert fused_splade._check(h, rb, False) == rb
    else:
        with pytest.raises(ValueError,
                           match=f"row_block {rb} at S={S} needs {need} "
                                 "bytes.*forward keeps column maxima"):
            fused_splade._check(h, rb, False)


@pytest.mark.parametrize("B,S,rb", [
    (128, 256, 8),      # the document batch
    (64, 64, 8),        # the query batch
    (8, 200, 8),
    (6, 40, 2),
    (3, 40, 1),         # an odd batch: row_block 1
    (1, 16, 1),         # a lone row
    (8, 32_384, 8),     # the longest sequence row_block 8 holds
    (8, 32_385, 4),     # one more: the next smaller row block that fits
    (8, 65_697, 2),
    (8, 132_305, 1),
    (1, 265_536, 1),    # the longest sequence row_block 1 holds
])
def test_routed_row_block_is_the_largest_that_fits(B, S, rb):
    """The per-row family runs the shared match pass at the largest of 8,
    4, 2, 1 that divides B and whose shared memory fits one block, so a long
    sequence steps down instead of being refused; past what row_block 1
    holds the refusal is ``_check``'s."""
    from splade_tpu_torch.ops import fused_splade

    h = torch.zeros(()).expand(B, S, 768)  # no storage
    assert fused_splade.routed_row_block(h) == rb
    assert fused_splade.PER_ROW.block_args(h, None, True) == [rb]
    assert fused_splade.PER_ROW.block_args(h, None, False) == []
    assert (match_shared_bytes(S, rb) + fused_splade.STATIC_SHARED_BYTES
            <= fused_splade.MAX_SHARED_BYTES)
    if S == 265_536:
        with pytest.raises(ValueError, match="match pass"):
            fused_splade.routed_row_block(
                torch.zeros(()).expand(B, S + 1, 768))


def _exact_match_case(seed, B, S, H=24, V=300):
    """Small-integer inputs (every score exact in f32 in any order, exact
    ties common), a fully padded last row, holes in the mask, g = 0 in
    every 7th column and a few more."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.integers(-2, 3, (B, S, H)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-2, 3, (V, H)).astype(np.float32))
    bias = torch.from_numpy(rng.integers(-2, 3, (V,)).astype(np.float32))
    lengths = rng.integers(1, S + 1, size=(B,))
    lengths[-1] = 0
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int64)
    mask[0, 1::5] = 0                     # holes inside a row
    mask = torch.from_numpy(mask)
    m, _ = fused_splade_pool_plain(h, w, bias, mask)
    g_pre = fold_cotangent(torch.from_numpy(
        rng.normal(size=(B, V)).astype(np.float32)), m)
    g_pre[:, ::7] = 0.0
    return h, w, bias, mask, m, g_pre


@pytest.mark.parametrize("row_block", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [40, 37, 64])
def test_v2_match_plain_equals_the_per_row_bitmask(row_block, S):
    """The row-blocked match pass's plain version walks the row blocks as
    the kernel does and gives the per-row plain bitmask bit for bit: exact
    ties kept, nothing on the padded row, a hole, a g = 0 column or past S
    (S = 37 and 40 end inside a 16-row group and a 32-position word; V =
    300 leaves a ragged last vocab tile). On a CPU tensor the wrapper is
    the plain version and counts no launch."""
    B = 8
    h, w, bias, mask, m, g_pre = _exact_match_case(S + row_block, B, S)
    want = fused_splade_bwd_match_plain(h, w, bias, mask, m, g_pre)
    got = fused_splade_bwd_match_v2_plain(h, w, bias, mask, m, g_pre,
                                          row_block)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    before = fused_splade_bwd_match_v2.launches
    assert torch.equal(fused_splade_bwd_match_v2(h, w, bias, mask, m, g_pre,
                                                 row_block), want)
    assert fused_splade_bwd_match_v2.launches == before
    r = torch.arange(32, dtype=torch.int32)
    bits = ((got[:, :, None, :] >> r[None, None, :, None]) & 1).view(
        B, -1, got.shape[2])
    assert int(bits[:, :, ::7].sum()) == 0 and int(bits[-1].sum()) == 0
    assert int(bits[:, S:].sum()) == 0
    assert int((bits[:, :S] * (mask[:, :, None] == 0)).sum()) == 0
    live = (g_pre != 0) & (mask.sum(1, keepdim=True) > 0)
    assert bool((bits.sum(1)[live] >= 1).all())  # every maximum found
    assert int((bits.sum(1) > 1).sum()) > 0      # exact ties, every one kept


@pytest.mark.parametrize("splits", [2, 3, 5])
def test_v2_split_dh_gather_equals_the_unsplit_one_and_jax(splits):
    """The dh gather's plain version over ordered vocab ranges equals the
    unsplit gather within 1e-6 and, from the row-blocked bitmask, the JAX
    fused_splade_pool_v2 VJP's dh (Pallas, interpret mode) within the
    gradient tolerance; so does the whole backward through the match pass
    and both gathers."""
    from splade_tpu_torch.ops.fused_splade import fused_splade_gather_dw_plain

    B, row_block = 4, 2
    h, w, bias, mask = (torch.from_numpy(x) for x in _case(17, B, V=300))
    m, _ = fused_splade_pool_v2_plain(h, w, bias, mask, row_block)
    p = torch.log1p(torch.relu(m))
    g_pre = fold_cotangent(torch.cos(p) * p + torch.sin(p), m)
    match = fused_splade_bwd_match_v2_plain(h, w, bias, mask, m, g_pre,
                                            row_block)
    whole = fused_splade_gather_dh_plain(match, w, g_pre, h.shape[1])
    split = fused_splade_gather_dh_plain(match, w, g_pre, h.shape[1], splits)
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-6)
    assert len(vocab_ranges(300, splits)) == splits
    _, _, want = _jax_out_and_grads(*(x.numpy() for x in (h, w, bias, mask)),
                                    row_block)
    np.testing.assert_allclose(split.numpy(), want[0], **GRAD_TOL)
    dw = fused_splade_gather_dw_plain(match, h, g_pre)
    np.testing.assert_allclose(dw.numpy(), want[1], **GRAD_TOL)


class _RecordingLibrary:
    """Stands in for the built kernel library: every entry records its
    arguments and reports success, so the launchers can run on CPU tensors."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return 0
        return call


@pytest.mark.parametrize("family,B,row_block,fwd_extra,match_extra", [
    ("PER_ROW", 4, None, (), (4,)),      # the match pass at pick_row_block(B)
    ("PER_ROW", 3, None, (), (1,)),      # an odd batch: row_block 1
    ("PER_ROW", 1, None, (), (1,)),      # a lone row
    ("ROW_BLOCKED", 4, 0, (4,), (4,)),   # B = 4: the automatic row block
    ("ROW_BLOCKED", 4, 2, (2,), (2,)),
    ("ROW_BLOCKED", 4, 1, (1,), (1,)),
])
def test_launchers_count_where_they_launch_and_nowhere_else(
        monkeypatch, family, B, row_block, fwd_extra, match_extra):
    """Both families go through one set of launchers: each adds one to its
    kernel's count after the C entry returned, never for an empty batch;
    the entry's name and its integer arguments (B, S, H, V, the row block,
    the dh gather's hidden slices and vocab splits) are the family's: the
    row-blocked forward hands its row block to the walk's C entry. Each
    backward call runs the one match pass both families share
    (``splade_fused_pool_v2_bwd_match``, the per-row family at
    ``pick_row_block(B)``) once and then the gathers asked for, which both
    families share too."""
    from splade_tpu_torch.ops import _cuda, fused_splade, fused_splade_v2

    fam = getattr(fused_splade_v2 if family == "ROW_BLOCKED" else fused_splade,
                  family)
    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    for fn in fam.counted.values():
        monkeypatch.setattr(fn, "launches", 0)
    S, H, V = 16, 32, 300
    h, w, bias, mask = (torch.from_numpy(x) for x in _case(5, B, S, H, V))
    m, g = torch.zeros(B, V), torch.ones(B, V)
    count = lambda: {k: fn.launches for k, fn in fam.counted.items()}
    zero = dict.fromkeys(fam.counted, 0)
    assert set(zero) == {"fwd", "match", "dh", "dw"}

    fused_splade._launch_fwd(fam, h[:0], w, bias, mask[:0], row_block)
    empty = fused_splade._launch_bwd(fam, ("dh", "dw"), h[:0], w, bias,
                                     mask[:0], m[:0], g[:0], row_block)
    assert lib.calls == [] and count() == zero
    assert empty["dh"].shape == (0, S, H) and empty["dw"].shape == (V, H)
    assert float(empty["dw"].abs().max()) == 0.0

    fused_splade._launch_fwd(fam, h, w, bias, mask, row_block)
    assert count() == dict(zero, fwd=1)
    fused_splade._launch_bwd(fam, ("dh",), h, w, bias, mask, m, g, row_block)
    fused_splade._launch_bwd(fam, ("dw",), h, w, bias, mask, m, g, row_block)
    out = fused_splade._launch_bwd(fam, ("dh", "dw"), h, w, bias, mask, m, g,
                                   row_block)
    assert set(out) == {"dh", "dw"} and out["dh"].shape == (B, S, H)
    # the whole hidden width, ordered vocab ranges, for both families
    hidden, vocab = dh_splits(B, S, H, V)
    assert (hidden, vocab) == (1, dh_vocab_splits_v2(B, S, V)) == (1, 10)
    # the forward: 6 pointers, then the ints and the stream
    assert [(e, a[6:-1]) for e, a in lib.calls[:1]] == [
        (fam.fwd_entry, (B, S, H, V, *fwd_extra))]
    # one match pass a backward call, then the gathers asked for
    assert count() == dict(fwd=1, match=3, dh=2, dw=2)
    # the match pass: 7 pointers; the gathers: 4
    ints = [(e, a[7 if e.endswith("_match") else 4:-1])
            for e, a in lib.calls[1:]]
    match = ("splade_fused_pool_v2_bwd_match", (B, S, H, V, *match_extra))
    dh = ("splade_fused_pool_bwd_dh", (B, S, H, V, hidden, vocab))
    dw = ("splade_fused_pool_bwd_dw", (B, S, H, V))
    assert ints == [match, dh, match, dw, match, dh, dw]
    # no other C entry: the match pass is the shared one for both families
    assert {e for e, _ in lib.calls} == {fam.fwd_entry, match[0], dh[0],
                                         dw[0]}
