"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here carries the ``gpu`` marker and skips where there is
no CUDA device: a CUDA kernel has no CPU mode. The file imports neither JAX
nor ``splade_tpu``, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from splade_tpu_torch.ops.fused_splade import (fold_cotangent,
                                               fused_splade_bwd_dh,
                                               fused_splade_bwd_dw,
                                               fused_splade_bwd_match,
                                               fused_splade_bwd_match_plain,
                                               fused_splade_bwd_plain,
                                               fused_splade_gather_dh,
                                               fused_splade_gather_dh_plain,
                                               fused_splade_gather_dw,
                                               fused_splade_gather_dw_plain,
                                               fused_splade_maxima,
                                               fused_splade_pool,
                                               fused_splade_pool_plain,
                                               match_words)
from splade_tpu_torch.ops.fused_splade_v2 import (
    fused_splade_bwd_dh_v2, fused_splade_bwd_dw_v2, fused_splade_bwd_match_v2,
    fused_splade_bwd_match_v2_plain, fused_splade_maxima_v2,
    fused_splade_pool_v2)
from splade_tpu_torch.ops import splash_attention as sa
from splade_tpu_torch.ops.rescore_kernel import (rescore_match,
                                                 rescore_match_plain,
                                                 rescore_match_rows)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool_case(B, S, H, V, seed, device):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, S, H, generator=g).to(torch.bfloat16)
    w = (torch.randn(V, H, generator=g) * 0.05).to(torch.bfloat16)
    bias = torch.randn(V, generator=g) * 0.1
    lens = torch.randint(1, S + 1, (B,), generator=g)
    lens[-1] = 0  # one fully padded row: must pool to 0
    mask = (torch.arange(S)[None, :] < lens[:, None]).to(torch.int64)
    return [t.to(device) for t in (h, w, bias, mask)]


@pytest.mark.parametrize("B,S,H,V", [
    (4, 64, 768, 50000),     # query encode width, ragged last vocab tile
    (3, 100, 64, 1000),      # S not a multiple of the 64-row chunk
    (2, 256, 768, 50000),    # document encode length
    (4, 256, 2048, 128256),  # the DeepSeek-V3 backbone: H 2,048, V 128,256
])
def test_fused_pool_kernel_matches_plain(cuda, B, S, H, V):
    h, w, bias, mask = _pool_case(B, S, H, V, seed=B * S, device=cuda)
    before = fused_splade_pool.launches
    with torch.no_grad():
        pooled, tw = fused_splade_pool(h, w, bias, mask)
        m_ref, pos_ref = fused_splade_pool_plain(h, w, bias, mask)
    torch.cuda.synchronize()
    assert fused_splade_pool.launches == before + 1
    ref_pooled = torch.log1p(torch.relu(m_ref))
    ref_tw = torch.log1p(torch.relu(pos_ref)) * mask.float()
    # bf16 products are exact in f32; only the order of the H-term sums
    # differs between the tensor cores and the f32 matmul
    torch.testing.assert_close(pooled, ref_pooled, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(tw, ref_tw, rtol=1e-4, atol=1e-3)
    assert float(pooled[-1].abs().max()) == 0.0
    assert float(tw[-1].abs().max()) == 0.0


POOL_FWD_SHAPES = [
    (5, 256, 768, 50000),   # document length; B not a multiple of 4 a block
    (17, 64, 768, 50000),   # query length; B not a multiple of 16 a block
    (3, 200, 768, 50000),   # S not a multiple of the 16-row group
    (6, 37, 64, 777),       # ragged everywhere, H < 768
    (2, 1500, 64, 1000),    # S above the rows a block aims at: one a block
]


@pytest.mark.parametrize("B,S,H,V", POOL_FWD_SHAPES)
def test_pool_forward_bitwise_plain_on_exact_inputs(cuda, B, S, H, V):
    """Small-integer inputs make every score exact in f32 in any order, so
    the forward kernel's m and pos equal the plain version's bit for bit:
    a ragged S and last vocab tile, a fully padded row (m and pos -1e30),
    and rows with holes in the mask (a live group after a skipped one)."""
    h, w, bias, mask, _ = _bwd_case(B, S, H, V, seed=B + S + V,
                                    device=cuda, exact=True)
    mask[0, 16:48] = 0    # two dead groups inside a row
    mask[0, 48:S] = 1     # ... and live ones after them
    if B > 2:
        mask[1] = 0
        mask[1, S - 1] = 1  # one valid position, in the last group
    before = fused_splade_pool.launches
    m, pos = fused_splade_maxima(h, w, bias, mask)
    torch.cuda.synchronize()
    assert fused_splade_pool.launches == before + 1
    m_ref, pos_ref = fused_splade_pool_plain(h, w, bias, mask)
    assert torch.equal(m, m_ref)
    assert torch.equal(pos, pos_ref)
    assert bool((m[-1] == -1e30).all()) and bool((pos[-1] == -1e30).all())
    again = fused_splade_maxima(h, w, bias, mask)
    assert torch.equal(again[0], m) and torch.equal(again[1], pos)


@pytest.mark.parametrize("B,S", [(32, 256), (32, 64), (128, 256), (64, 64)])
def test_pool_forward_at_the_served_and_training_shapes(cuda, B, S):
    """Model-like inputs at the shapes the serving and training paths give
    the forward: m and pos within f32 sum order of the plain version, and m
    bitwise the row-blocked family's."""
    H, V = 768, 50000
    h, w, bias, mask, _ = _bwd_case(B, S, H, V, seed=B * S, device=cuda,
                                    exact=False)
    hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
    m, pos = fused_splade_maxima(hb, wb, bias, mask)
    m_ref, pos_ref = fused_splade_pool_plain(hb, wb, bias, mask)
    torch.testing.assert_close(m, m_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(pos, pos_ref, rtol=1e-4, atol=1e-3)
    m2, pos2 = fused_splade_maxima_v2(hb, wb, bias, mask, 0)
    assert torch.equal(m, m2) and torch.equal(pos, pos2)


@pytest.mark.parametrize("B,S,H,V", [(32, 256, 768, 50000),
                                     (6, 37, 64, 777)])
def test_pool_forward_block_orders_agree_bitwise(cuda, B, S, H, V):
    """The measurement entry that numbers the forward's blocks batch range
    first does the same work: m and pos bitwise the wrapper's."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import float_from_key, float_key

    h, w, bias, mask, _ = _bwd_case(B, S, H, V, seed=B + S, device=cuda,
                                    exact=False)
    hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
    m, pos = fused_splade_maxima(hb, wb, bias, mask)
    m2 = torch.empty_like(m)
    pos_key = torch.full((B, S), int(float_key(torch.tensor(-1e30))),
                         dtype=torch.int32, device=cuda)
    maskf = mask.float().contiguous()
    _cuda.check(_cuda.library().splade_fused_pool_fwd_batch_first(
        hb.data_ptr(), wb.data_ptr(), bias.data_ptr(), maskf.data_ptr(),
        m2.data_ptr(), pos_key.data_ptr(), B, S, H, V,
        torch.cuda.current_stream().cuda_stream),
        "splade_fused_pool_fwd_batch_first")
    torch.cuda.synchronize()
    assert torch.equal(m2, m)
    assert torch.equal(float_from_key(pos_key), pos)


def _bwd_case(B, S, H, V, seed, device, exact):
    """f32 tensors holding bf16 values (the kernels' operands, so the
    gradients come back in f32). exact: small integers, so every score is
    exact in f32 in any order and exact ties are common; else realistic."""
    g = torch.Generator().manual_seed(seed)
    if exact:
        h = torch.randint(-2, 3, (B, S, H), generator=g).float()
        w = torch.randint(-2, 3, (V, H), generator=g).float()
        bias = torch.randint(-2, 3, (V,), generator=g).float()
    else:
        h = torch.randn(B, S, H, generator=g).to(torch.bfloat16).float()
        w = (torch.randn(V, H, generator=g) * 0.05).to(torch.bfloat16).float()
        bias = torch.randn(V, generator=g) * 0.1
    lens = torch.randint(1, S + 1, (B,), generator=g)
    lens[-1] = 0  # a fully padded row: zero, finite gradient
    mask = (torch.arange(S)[None, :] < lens[:, None]).to(torch.int64)
    gout = torch.randn(B, V, generator=g)
    return [t.to(device) for t in (h, w, bias, mask, gout)]


def _kernel_route(h, w, bias, mask, gout):
    """forward kernel -> backward kernels, through autograd"""
    leaves = [t.clone().requires_grad_() for t in (h, w, bias)]
    pooled, _ = fused_splade_pool(*leaves, mask)
    (pooled * gout).sum().backward()
    return [t.grad for t in leaves]


def _plain_route(h, w, bias, mask, gout):
    """plain forward -> plain backward, on the same inputs"""
    m, _ = fused_splade_pool_plain(h, w, bias, mask)
    g_pre = fold_cotangent(gout, m)
    dh, dw = fused_splade_bwd_plain(h, w, bias, mask, m, g_pre)
    return [dh, dw, g_pre.sum(0)]


BWD_SHAPES = [
    (3, 100, 64, 1000),     # S not a multiple of either row chunk, ragged V
    (5, 37, 64, 777),       # ragged everywhere
    (4, 64, 768, 50000),    # query width, vocab split 16 ways in dh
    (2, 256, 768, 50000),   # document length
    (64, 64, 768, 50000),   # the training step's query batch
    (128, 256, 768, 50000),  # the training step's documents (64 + 64)
    (8, 64, 1024, 5000),    # wider than a gather slice: H cut in slices
    (4, 256, 2048, 128256),  # the DeepSeek-V3 backbone: three slices
]


@pytest.mark.parametrize("B,S,H,V", BWD_SHAPES)
def test_fused_pool_backward_exact_inputs(cuda, B, S, H, V):
    """Check (a): exactly representable inputs with many exact ties; the
    kernel route equals the plain route elementwise (only f32 sum order
    differs), ties getting duplicate gradient in both."""
    case = _bwd_case(B, S, H, V, seed=B * S + V, device=cuda, exact=True)
    dh0, dw0 = fused_splade_bwd_dh.launches, fused_splade_bwd_dw.launches
    got = _kernel_route(*case)
    torch.cuda.synchronize()
    assert (fused_splade_bwd_dh.launches, fused_splade_bwd_dw.launches) == (
        dh0 + 1, dw0 + 1)
    want = _plain_route(*case)
    for name, a, b in zip(("dh", "dw", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=name)
    assert float(got[0][-1].abs().max()) == 0.0  # the padded row


@pytest.mark.parametrize("B,S,H,V", BWD_SHAPES)
def test_fused_pool_backward_realistic_inputs(cuda, B, S, H, V):
    """Check (b): near-ties may pick another argmax in the two routes, so
    the whole tensors are compared by norm."""
    case = _bwd_case(B, S, H, V, seed=B * S + V, device=cuda, exact=False)
    got = _kernel_route(*case)
    want = _plain_route(*case)
    for name, a, b in zip(("dh", "dw", "dbias"), got, want):
        rel = float((a - b).norm() / b.norm())
        assert rel <= 1e-2, (name, rel)
    assert float(got[0][-1].abs().max()) == 0.0
    again = _kernel_route(*case)  # deterministic: no atomics
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def _recompute_check():
    """chip_smoke.py's check (c), loaded from the repository's root"""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.recompute_check


@pytest.mark.parametrize("B,S,H,V", BWD_SHAPES)
def test_fused_pool_backward_recomputes_the_forward(cuda, B, S, H, V):
    """Check (c): with g_pre = 1 on the valid rows every column sends its W
    row to the position(s) where the forward kernel found its maximum, so
    sum_s dh[b, s] = sum_v n[b, v] W[v], n the count of positions that
    reach it (more than 1 only at an exact f32 tie). Every valid row must
    hold within 1e-3 once its ties are counted; a recompute off by one ulp
    would lose most columns of every row."""
    h, w, bias, mask, _ = _bwd_case(B, S, H, V, seed=V, device=cuda,
                                    exact=False)
    before = fused_splade_pool.launches
    m, _ = fused_splade_maxima(h, w, bias, mask)
    assert fused_splade_pool.launches == before + 1
    ones = (mask.sum(1, keepdim=True) > 0).float().expand_as(m)
    dh = fused_splade_bwd_dh(h, w, bias, mask, m, ones)
    out = _recompute_check()(torch, h, w, bias, mask, m, dh)
    assert out["ok"], out


# ---- the per-row backward's match pass and gathers, one at a time ------
MATCH_SHAPES = BWD_SHAPES + [
    (8, 200, 768, 50000),    # S not a multiple of 32: a ragged last word
    (3, 40, 768, 50000),     # an odd batch (row_block 1), a ragged last word
]


@pytest.mark.parametrize("B,S,H,V", MATCH_SHAPES)
def test_match_kernel_equals_plain_on_exact_inputs(cuda, B, S, H, V):
    """Small-integer inputs: every score is exact in f32 in any order, so
    the match pass's bitmask equals the plain one bit for bit, every exact
    tie included, given the same maxima. Columns with g = 0 get no bit, nor
    do invalid positions, the padded row or bits past S."""
    h, w, bias, mask, gout = _bwd_case(B, S, H, V, seed=B * S + V + 1,
                                       device=cuda, exact=True)
    m, _ = fused_splade_maxima(h, w, bias, mask)
    g_pre = fold_cotangent(gout, m)
    g_pre[:, ::5] = 0.0
    before = fused_splade_bwd_match.launches
    got = fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
    torch.cuda.synchronize()
    assert fused_splade_bwd_match.launches == before + 1
    assert got.shape == (B, match_words(S), V) and got.dtype == torch.int32
    want = fused_splade_bwd_match_plain(h, w, bias, mask, m, g_pre)
    assert torch.equal(got, want)
    bits = torch.stack([(got >> r) & 1 for r in range(32)], 2).view(
        B, -1, V)
    assert int(bits[:, :, ::5].sum()) == 0 and int(bits[-1].sum()) == 0
    assert int(bits[:, S:].sum()) == 0
    ties = int((bits.sum(1) > 1).sum())
    assert ties > 0  # exact ties are common here, and every one is kept


@pytest.mark.parametrize("B,S,H,V", MATCH_SHAPES)
def test_match_kernel_reaches_the_forward_kernels_maxima(cuda, B, S, H, V):
    """Model-like inputs: with the forward kernel's maxima, every column of
    a valid row whose g is not 0 finds at least one position (a recompute one
    ulp off would find almost none), and bits stand only on valid
    positions."""
    h, w, bias, mask, gout = _bwd_case(B, S, H, V, seed=V + S, device=cuda,
                                       exact=False)
    m, _ = fused_splade_maxima(h, w, bias, mask)
    g_pre = fold_cotangent(gout, m)
    got = fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
    bits = torch.stack([(got >> r) & 1 for r in range(32)], 2).view(
        B, -1, V)[:, :S]
    live = (g_pre != 0) & (mask.sum(1, keepdim=True) > 0)
    assert bool((bits.sum(1)[live] >= 1).all())
    assert int(bits.sum(1)[~live].sum()) == 0
    assert int((bits * (mask[:, :, None] == 0)).sum()) == 0
    again = fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
    assert torch.equal(got, again)


def _random_bitmask(B, S, V, dense, seed, device):
    """Words with no bit past S. Sparse: one bit a (b, v) column at a
    random position, a second one in every 20th column (a tie), as training
    gives; dense: each bit with probability 0.1, so many words hold several
    bits and the gathers' tie paths run everywhere."""
    g = torch.Generator(device=device).manual_seed(seed)
    J = match_words(S)
    if dense:
        bits = torch.rand(B, J * 32, V, generator=g, device=device) < 0.1
        bits[:, S:] = False
        bits = bits.view(B, J, 32, V).to(torch.int32)
        words = torch.zeros(B, J, V, dtype=torch.int32, device=device)
        for r in range(32):
            words |= bits[:, :, r] << r
        return words
    pos = torch.randint(0, S, (B, V), generator=g, device=device)
    other = (pos + 1 + torch.randint(0, max(S - 1, 1), (B, V), generator=g,
                                     device=device)) % S
    b = torch.arange(B, device=device)[:, None].expand(B, V)
    v = torch.arange(V, device=device)[None].expand(B, V)
    words = torch.zeros(B * J * V, dtype=torch.int32, device=device)
    for p_, keep in ((pos, torch.ones_like(pos, dtype=torch.bool)),
                     (other, (v % 20 == 0) & (other != pos))):
        at = ((b * J + p_ // 32) * V + v)[keep]
        words.index_put_((at,), (1 << (p_ % 32)).to(torch.int32)[keep],
                         accumulate=True)  # distinct bits: a sum is an OR
    return words.view(B, J, V)


@pytest.mark.parametrize("B,S,H,V", MATCH_SHAPES)
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_gather_kernels_equal_plain(cuda, B, S, H, V, dense):
    """The dh and dW gathers from one bitmask against their plain versions,
    elementwise: only the order of f32 sums differs. Repeated calls are
    bitwise equal."""
    if dense and B * S * V > 4e7:
        B = 2  # the dense mask at the long shapes: two rows are enough
    h, w, _, _, gout = _bwd_case(B, S, H, V, seed=B + S + V, device=cuda,
                                 exact=False)
    match = _random_bitmask(B, S, V, dense, seed=S + V, device=cuda)
    counts = (fused_splade_bwd_dh.launches, fused_splade_bwd_dw.launches)
    dh = fused_splade_gather_dh(match, w, gout, S)
    dw = fused_splade_gather_dw(match, h, gout)
    torch.cuda.synchronize()
    assert (fused_splade_bwd_dh.launches,
            fused_splade_bwd_dw.launches) == (counts[0] + 1, counts[1] + 1)
    want_dh = fused_splade_gather_dh_plain(match, w, gout, S)
    want_dw = fused_splade_gather_dw_plain(match, h, gout)
    for name, a, b in (("dh", dh, want_dh), ("dw", dw, want_dw)):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()), msg=name)
    assert torch.equal(dh, fused_splade_gather_dh(match, w, gout, S))
    assert torch.equal(dw, fused_splade_gather_dw(match, h, gout))


# ---- the row-blocked family (ops/fused_splade_v2.py) ----------------------
V2_SHAPES = [
    (6, 100, 64, 1000, 3),      # chunks cross batch rows, ragged V, H < 768
    (5, 37, 64, 777, 1),        # ragged everywhere, one row a block
    (8, 64, 768, 50000, 8),     # query width, one row block, 16 vocab splits
    (4, 256, 768, 50000, 2),    # document length
    (64, 64, 768, 50000, 0),    # the training step's query batch (picks 8)
    (128, 256, 768, 50000, 4),  # the training step's documents
    (8, 64, 1024, 5000, 4),     # two dh slices of 512, dW slices 768 + 256
]


@pytest.mark.parametrize("B,S,H,V,rb", V2_SHAPES + [
    (2, 16, 2048, 100, 2),      # a hidden width the walk streams
    (16, 512, 768, 5000, 16),   # row_block = B: one batch range a tile
])
def test_v2_forward_equals_v1_bitwise_and_plain(cuda, B, S, H, V, rb):
    """Both families launch one kernel and one epilogue, with another
    number of batch rows a block, and a maximum has no order: the
    row-blocked m and pos equal the per-row kernel's bit for bit. Against
    the plain version only f32 sum order differs."""
    h, w, bias, mask = _pool_case(B, S, H, V, seed=B * S + rb, device=cuda)
    before = fused_splade_pool_v2.launches
    with torch.no_grad():
        m2, pos2 = fused_splade_maxima_v2(h, w, bias, mask, rb)
        m1, pos1 = fused_splade_maxima(h, w, bias, mask)
        pooled, tw = fused_splade_pool_v2(h, w, bias, mask, rb)
        m_ref, pos_ref = fused_splade_pool_plain(h, w, bias, mask)
    torch.cuda.synchronize()
    assert fused_splade_pool_v2.launches == before + 2
    assert torch.equal(m2, m1) and torch.equal(pos2, pos1)
    torch.testing.assert_close(pooled, torch.log1p(torch.relu(m_ref)),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(
        tw, torch.log1p(torch.relu(pos_ref)) * mask.float(), rtol=1e-4,
        atol=1e-3)
    assert float(pooled[-1].abs().max()) == 0.0
    assert float(tw[-1].abs().max()) == 0.0


def _kernel_route_v2(h, w, bias, mask, gout, rb):
    leaves = [t.clone().requires_grad_() for t in (h, w, bias)]
    pooled, _ = fused_splade_pool_v2(*leaves, mask, rb)
    (pooled * gout).sum().backward()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("B,S,H,V,rb", V2_SHAPES)
def test_v2_backward_exact_inputs(cuda, B, S, H, V, rb):
    """Check (a) for the row-blocked family, at the per-row family's
    tolerance; one backward call runs one match pass and one gather a
    gradient."""
    case = _bwd_case(B, S, H, V, seed=B * S + V, device=cuda, exact=True)
    counters = (fused_splade_bwd_match_v2, fused_splade_bwd_dh_v2,
                fused_splade_bwd_dw_v2)
    before = [fn.launches for fn in counters]
    got = _kernel_route_v2(*case, rb)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 1]
    want = _plain_route(*case)
    for name, a, b in zip(("dh", "dw", "dbias"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=name)
    assert float(got[0][-1].abs().max()) == 0.0


@pytest.mark.parametrize("B,S,H,V,rb", V2_SHAPES)
def test_v2_backward_realistic_inputs(cuda, B, S, H, V, rb):
    """Check (b) by norm against the plain route and the per-row kernel
    route; a repeated call is bitwise equal (no atomics)."""
    case = _bwd_case(B, S, H, V, seed=B * S + V, device=cuda, exact=False)
    got = _kernel_route_v2(*case, rb)
    for other in (_plain_route(*case), _kernel_route(*case)):
        for name, a, b in zip(("dh", "dw", "dbias"), got, other):
            rel = float((a - b).norm() / b.norm())
            assert rel <= 1e-2, (name, rel)
    assert float(got[0][-1].abs().max()) == 0.0
    again = _kernel_route_v2(*case, rb)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,S,H,V,rb", V2_SHAPES)
def test_v2_backward_recomputes_either_forward(cuda, B, S, H, V, rb):
    """Check (c) with the per-row forward kernel's maxima: the row-blocked
    recompute must reach them exactly."""
    h, w, bias, mask, _ = _bwd_case(B, S, H, V, seed=V, device=cuda,
                                    exact=False)
    m, _ = fused_splade_maxima(h, w, bias, mask)
    ones = (mask.sum(1, keepdim=True) > 0).float().expand_as(m)
    dh = fused_splade_bwd_dh_v2(h, w, bias, mask, m, ones, rb)
    out = _recompute_check()(torch, h, w, bias, mask, m, dh)
    assert out["ok"], out
    dw = fused_splade_bwd_dw_v2(h, w, bias, mask, m, ones, rb)
    dw1 = fused_splade_bwd_dw(h, w, bias, mask, m, ones)
    assert float((dw - dw1).norm() / dw1.norm()) <= 1e-5


@pytest.mark.parametrize("B,S,H,V,rb", V2_SHAPES + [
    (8, 200, 768, 50000, 8),    # S not a multiple of 32: a ragged last word
    (16, 40, 768, 50000, 4),    # a group past S in the last word
    (128, 256, 768, 50000, 2),  # the documents at the other row block
    (64, 64, 768, 50000, 2),
])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "model"])
def test_v2_match_pass_equals_the_per_row_one_bitwise(cuda, B, S, H, V, rb,
                                                      exact):
    """The match pass's bitmask is the same bit for bit at every row block:
    at ``rb`` it equals row_block 1's and the per-row family's (its routed
    row block, ``routed_row_block``) on the same inputs and maxima, as
    every score keeps fused_splade_tile.cuh's products. Exact inputs also
    equal the plain row-blocked bitmask; on model-like inputs (holes in the
    mask, ragged lengths, a padded row, g = 0 columns) every maximum is
    found. A repeated call is bitwise equal and each call counts one
    launch."""
    h, w, bias, mask, gout = _bwd_case(B, S, H, V, seed=B + S + rb,
                                       device=cuda, exact=exact)
    mask[0, 1::7] = 0  # holes inside a row
    m, _ = fused_splade_maxima(h, w, bias, mask)
    g_pre = fold_cotangent(gout, m)
    g_pre[:, ::5] = 0.0
    before = fused_splade_bwd_match_v2.launches
    got = fused_splade_bwd_match_v2(h, w, bias, mask, m, g_pre, rb)
    torch.cuda.synchronize()
    assert fused_splade_bwd_match_v2.launches == before + 1
    assert got.shape == (B, match_words(S), V) and got.dtype == torch.int32
    assert torch.equal(got, fused_splade_bwd_match_v2(h, w, bias, mask, m,
                                                      g_pre, 1))
    before = fused_splade_bwd_match.launches
    assert torch.equal(got, fused_splade_bwd_match(h, w, bias, mask, m,
                                                   g_pre))
    assert fused_splade_bwd_match.launches == before + 1
    if exact:
        assert torch.equal(got, fused_splade_bwd_match_v2_plain(
            h, w, bias, mask, m, g_pre, rb))
    bits = torch.stack([(got >> r) & 1 for r in range(32)], 2).view(
        B, -1, V)
    live = (g_pre != 0) & (mask.sum(1, keepdim=True) > 0)
    assert bool((bits[:, :S].sum(1)[live] >= 1).all())
    assert int(bits[:, S:].sum()) == 0 and int(bits[:, :, ::5].sum()) == 0
    assert int((bits[:, :S] * (mask[:, :, None] == 0)).sum()) == 0
    assert torch.equal(got, fused_splade_bwd_match_v2(h, w, bias, mask, m,
                                                      g_pre, rb))


@pytest.mark.parametrize("B,S,rb", [
    (8, 32384, 8),   # the longest sequence row_block 8's shared memory holds
    (8, 32385, 4),   # one more: the next smaller row block
    (6, 40, 2),
    (3, 40, 1),
])
def test_routed_match_pass_takes_the_largest_row_block_that_fits(cuda, B, S,
                                                                 rb):
    """The per-row family's match pass runs at the largest of 8, 4, 2, 1
    that divides B and whose shared memory the built kernel reports as
    fitting, so it refuses no shape the row block 8 cannot hold; its bitmask
    equals the plain one on exact inputs."""
    from splade_tpu_torch.ops.fused_splade import routed_row_block

    H, V = 64, 300
    h, w, bias, mask, gout = _bwd_case(B, S, H, V, seed=S + rb, device=cuda,
                                       exact=True)
    assert routed_row_block(h.to(torch.bfloat16)) == rb
    m, _ = fused_splade_maxima(h, w, bias, mask)
    g_pre = fold_cotangent(gout, m)
    got = fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
    assert torch.equal(got, fused_splade_bwd_match_plain(h, w, bias, mask, m,
                                                         g_pre))


@pytest.mark.parametrize("B,S", [(64, 64), (128, 256), (8, 200)])
@pytest.mark.parametrize("vocab_splits", [1, 3, 16])
def test_dh_gather_vocab_splits_equal_plain(cuda, B, S, vocab_splits):
    """The dh gather over ordered vocab ranges against the plain gather over
    the same ranges, elementwise (only f32 sum order differs within a
    range), and bitwise the same when repeated."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import (add_partials,
                                                   min_hidden_slices)

    H, V = 768, 50000
    h, w, _, _, gout = _bwd_case(B, S, H, V, seed=B + S, device=cuda,
                                 exact=False)
    match = _random_bitmask(B, S, V, False, seed=S + vocab_splits,
                            device=cuda)
    wb = w.to(torch.bfloat16).contiguous()
    parts = torch.empty((vocab_splits, B, S, H), device=cuda)

    def run():
        _cuda.check(_cuda.library().splade_fused_pool_bwd_dh(
            match.data_ptr(), wb.data_ptr(), gout.data_ptr(),
            parts.data_ptr(), B, S, H, V, min_hidden_slices(H),
            vocab_splits, torch.cuda.current_stream().cuda_stream),
            "splade_fused_pool_bwd_dh")
        return add_partials(parts.clone())

    got = run()
    want = fused_splade_gather_dh_plain(match, wb, gout, S, vocab_splits)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, run())


@pytest.mark.parametrize("S", [1, 37, 64, 200, 256, 512])
@pytest.mark.parametrize("rb", [1, 2, 4, 8])
def test_v2_shared_bytes_mirror_equals_the_kernels(cuda, S, rb):
    """``fwd_shared_bytes`` and ``match_shared_bytes`` mirror the layouts
    the two ``.cu`` files compute for themselves, and
    ``STATIC_SHARED_BYTES`` the kernels' static shared memory; the launch
    path asks the built kernels."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade import (STATIC_SHARED_BYTES,
                                                   fwd_shared_bytes,
                                                   match_shared_bytes)

    lib = _cuda.library()
    assert lib.splade_fused_pool_v2_fwd_static_bytes() == STATIC_SHARED_BYTES
    assert lib.splade_fused_pool_v2_bwd_static_bytes() == STATIC_SHARED_BYTES
    assert fwd_shared_bytes(S, rb) == (
        lib.splade_fused_pool_v2_fwd_shared_bytes(S, rb))
    assert match_shared_bytes(S, rb) == (
        lib.splade_fused_pool_v2_bwd_shared_bytes(S, rb))


def test_v2_refuses_a_row_block_its_shared_memory_cannot_hold(cuda):
    """256 batch rows a block at S = 512: their column keys and 16-row
    groups need more than one block's shared memory, so the forward is
    refused before anything launches."""
    h, w, bias, mask = _pool_case(256, 512, 64, 100, seed=1, device=cuda)
    before = fused_splade_pool_v2.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_splade_maxima_v2(h, w, bias, mask, 256)
    assert fused_splade_pool_v2.launches == before


def test_an_empty_batch_launches_and_counts_nothing(cuda):
    h, w, bias, mask = _pool_case(4, 16, 64, 100, seed=2, device=cuda)
    m, g = torch.zeros(0, 100, device=cuda), torch.ones(0, 100, device=cuda)
    fns = (fused_splade_pool, fused_splade_bwd_match, fused_splade_bwd_dh,
           fused_splade_bwd_dw, fused_splade_pool_v2,
           fused_splade_bwd_match_v2, fused_splade_bwd_dh_v2,
           fused_splade_bwd_dw_v2)
    before = [fn.launches for fn in fns]
    assert fused_splade_maxima(h[:0], w, bias, mask[:0])[0].shape == (0, 100)
    match = fused_splade_bwd_match(h[:0], w, bias, mask[:0], m, g)
    assert match.shape == (0, 1, 100)
    assert fused_splade_gather_dh(match, w, g, 16).shape == (0, 16, 64)
    assert float(fused_splade_gather_dw(match, h[:0], g).abs().max()) == 0
    assert fused_splade_maxima_v2(h[:0], w, bias, mask[:0])[0].shape == (0, 100)
    assert fused_splade_bwd_match_v2(h[:0], w, bias, mask[:0], m,
                                     g).shape == (0, 1, 100)
    for dh, dw in ((fused_splade_bwd_dh, fused_splade_bwd_dw),
                   (fused_splade_bwd_dh_v2, fused_splade_bwd_dw_v2)):
        assert dh(h[:0], w, bias, mask[:0], m, g).shape == (0, 16, 64)
        assert float(dw(h[:0], w, bias, mask[:0], m, g).abs().max()) == 0.0
    assert [fn.launches for fn in fns] == before


def _rescore_case(N, M, V, B, T, C, seed, device, query="random"):
    """Doc-major rows of random lengths (pad id V, value 0) and random
    candidates. The query: "random" terms with one duplicate and one pad
    slot; "one_term", every slot the same term, each of weight about 1/T;
    "colliding", distinct terms that share their first slot in the kernel's
    largest hash table, and so in every smaller one (the slot is the top
    bits of the id's product with 2654435769, as in ``csrc/rescore.cu``).
    The first candidates hold the query's terms, so scores are not all
    zero."""
    rng = np.random.default_rng(seed)
    d_terms = np.full((N, M), V, np.int32)
    d_vals = np.zeros((N, M), np.int8)
    nnz = rng.integers(0, M + 1, N)
    for i in range(N):
        d_terms[i, :nnz[i]] = rng.choice(V, nnz[i], replace=False)
        d_vals[i, :nnz[i]] = rng.integers(1, 127, nnz[i])
    d_scale = rng.uniform(0.01, 0.1, N).astype(np.float32)
    q_val = rng.uniform(0.1, 2.0, (B, T)).astype(np.float32)
    if query == "one_term":
        q_idx = np.repeat(rng.integers(0, V, (B, 1)), T, 1).astype(np.int32)
        q_val /= T
    elif query == "colliding":
        ids = np.arange(V, dtype=np.uint64)
        home = ((ids * 2654435769 % 2 ** 32) >> 22).astype(np.int64)
        ids = ids[home == np.bincount(home).argmax()]
        q_idx = np.stack([rng.permutation(ids)[:T] for _ in range(B)])
        q_idx = q_idx.astype(np.int32)
    else:
        q_idx = rng.integers(0, V, (B, T)).astype(np.int32)
        q_idx[:, 1] = q_idx[:, 0]         # duplicate query terms accumulate
        q_val[:, -1] = 0.0                # a pad query slot
    cand = rng.integers(0, N, (B, C)).astype(np.int64)
    for j in range(min(C, 64)):           # plant the query's terms
        d_terms[cand[:, j], j % M] = q_idx[:, j % T]
        d_vals[cand[:, j], j % M] = rng.integers(1, 127, B)
    return [torch.from_numpy(x).to(device) for x in
            (d_terms, d_vals, d_scale, q_idx, q_val, cand)]


@pytest.mark.parametrize("N,M,V,B,T,C,query", [
    (100_000, 64, 50000, 32, 64, 1000, "random"),  # the serving shape
    (500, 13, 700, 5, 12, 37, "random"),   # unaligned B, C and M: scalar path
    (20_000, 64, 50000, 8, 256, 300, "random"),    # T = MAX_T
    (20_000, 64, 50000, 8, 64, 300, "one_term"),
    (20_000, 64, 300_000, 8, 256, 300, "colliding"),
    (20_000, 24, 50000, 3, 40, 130, "random"),  # M % 8 == 0 but not 64
])
def test_rescore_kernel_matches_plain(cuda, N, M, V, B, T, C, query):
    """Both public functions launch the kernel and match the plain version
    within 1e-4, and a repeated call is bitwise the first (the table sums a
    duplicated term's values in ascending t, whichever thread inserts it)."""
    case = _rescore_case(N, M, V, B, T, C, seed=N + T, device=cuda,
                         query=query)
    before = rescore_match.launches
    out = rescore_match(*case)
    out_rows = rescore_match_rows(*case)
    again = rescore_match(*case)
    ref = rescore_match_plain(*case)
    torch.cuda.synchronize()
    assert rescore_match.launches == before + 3
    assert float(ref.abs().max()) > 0
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(out_rows, ref, rtol=0, atol=1e-4)
    assert torch.equal(out, again)


def test_rescore_clamps_out_of_range_candidates(cuda):
    """A candidate id below 0 or at or past N reads row 0 or row N - 1, as
    XLA's gather clamps."""
    d_terms, d_vals, d_scale, q_idx, q_val, cand = _rescore_case(
        5000, 64, 50000, 4, 64, 200, seed=3, device=cuda)
    N = d_terms.shape[0]
    cand[:, ::7] = N + 5
    cand[:, 3::7] = -3
    cand[:, 5::7] = N - 1
    out = rescore_match(d_terms, d_vals, d_scale, q_idx, q_val, cand)
    ref = rescore_match_plain(d_terms, d_vals, d_scale, q_idx, q_val,
                              cand.clamp(0, N - 1))
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


def test_rescore_refuses_unaligned_rows(cuda):
    """At M % 8 == 0 the kernel reads 16-byte term and 8-byte value
    vectors: rows that do not start so aligned are refused, not read."""
    case = _rescore_case(500, 64, 700, 2, 8, 16, seed=4, device=cuda)
    d_terms, d_vals = case[0], case[1]
    shifted_terms = torch.empty(d_terms.numel() + 1, dtype=torch.int32,
                                device=cuda)[1:].view(d_terms.shape)
    shifted_vals = torch.empty(d_vals.numel() + 4, dtype=torch.int8,
                               device=cuda)[4:].view(d_vals.shape)
    shifted_terms.copy_(d_terms)
    shifted_vals.copy_(d_vals)
    before = rescore_match.launches
    for terms, vals in ((shifted_terms, d_vals), (d_terms, shifted_vals)):
        with pytest.raises(ValueError, match="aligned"):
            rescore_match(terms, vals, *case[2:])
    assert rescore_match.launches == before


# ---- the splash attention (ops/splash_attention.py) ------------------------
# kernels vs plain versions on the same bf16 operands: f32 scores and sums in
# both, then p and ds rounded to bf16 (an ulp flipped here and there: 2^-8 of
# a value) and the kernel's bf16 out (2^-9); relative to each tensor's largest
# value, as chip_smoke.py holds them
SPLASH_RTOL = 2.0 ** -7


def _splash_case(B, N, S, D, packed, seed, device, dtype=torch.bfloat16):
    """q and k as [B, N, S, D] views of [B, S, N, D] storage, v a strided
    view of a fused QKV tensor, dO, and segment ids with random lengths, a
    fully padded row and (packed) rows of 4 segments."""
    g = torch.Generator().manual_seed(seed)
    randn = lambda *shape: torch.randn(shape, generator=g).to(dtype).to(device)
    q = randn(B, S, N, D).transpose(1, 2)
    k = randn(B, S, N, D).transpose(1, 2)
    v = randn(B, S, 3, N, D)[:, :, 2].transpose(1, 2)
    d_out = randn(B, S, N, D)
    pos = torch.arange(S)[None]
    lens = torch.randint(1, S + 1, (B, 1), generator=g)
    lens[0] = 0
    mask = pos < lens
    segs = torch.zeros(B, S, dtype=torch.int64)
    if packed:
        width = -(-S // 4)
        segs[-1] = pos[0] // width
        seg_lens = torch.randint(0, width + 1, (4,), generator=g)
        mask[-1] = (pos[0] % width) < seg_lens[segs[-1]]
    seg = sa.segment_ids_with_padding(mask.long(), segs).to(device)
    return q, k, v, seg, d_out


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


SPLASH_SHAPES = [
    (2, 2, 64, 0, False),      # one tile
    (3, 4, 200, 64, False),    # ragged last tile, a window wider than a tile
    (5, 2, 37, 8, True),       # shorter than a tile, packed
    (4, 12, 256, 64, True),    # the V33 micro-batch's length and heads
    (2, 12, 512, 64, False),   # the MLM row: tiles outside the band skipped
    (2, 12, 512, 0, False),    # a global layer at that length
    (3, 3, 130, 1, True),      # a window of one neighbour each side
    (3, 2, 100, 4, True),      # ragged, a narrow window, packed
    (2, 3, 37, 0, False),      # shorter than a tile, full attention
    (144, 12, 256, 0, True),   # the V33 micro-batch, a global layer
    (32, 12, 512, 64, False),  # the MLM micro-batch, a local layer
]
# delta, the dq kernel's against the plain reduction: f32 sums in another
# order, about 1e-6 of the largest value
DELTA_RTOL = 1e-5


@pytest.mark.parametrize("B,N,S,hw,packed", SPLASH_SHAPES)
def test_splash_kernels_match_plain(cuda, B, N, S, hw, packed):
    q, k, v, seg, d_out = _splash_case(B, N, S, 64, packed, B * S + hw, cuda)
    fns = (sa.splash_attention, sa.splash_attention_bwd_dq,
           sa.splash_attention_bwd_dkv)
    before = [fn.launches for fn in fns]
    out, lse = sa.splash_attention_forward(q, k, v, seg, hw)
    dq, delta = sa.splash_attention_bwd_dq(q, k, v, seg, hw, d_out, out, lse)
    dk, dv = sa.splash_attention_bwd_dkv(q, k, v, seg, hw, d_out, lse, delta)
    torch.cuda.synchronize()
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    out_p, lse_p = sa.splash_attention_plain(q, k, v, seg, hw)
    delta_p = sa.splash_attention_delta(d_out, out)
    dq_p, dk_p, dv_p = sa.splash_attention_bwd_plain(q, k, v, seg, hw, d_out,
                                                     lse, delta_p)
    assert out.shape == (B, S, N, 64) and out.dtype == torch.bfloat16
    assert lse.shape == delta.shape == (B, N, S)
    assert {t.dtype for t in (dq, dk, dv, delta)} == {torch.float32}
    assert _rel(delta, delta_p) <= DELTA_RTOL, _rel(delta, delta_p)
    for name, got, want in (("out", out, out_p), ("dq", dq, dq_p),
                            ("dk", dk, dk_p), ("dv", dv, dv_p)):
        assert torch.isfinite(got).all(), name
        assert _rel(got, want) <= SPLASH_RTOL, (name, _rel(got, want))
    # padded rows included: their lse is finite and agrees
    assert torch.isfinite(lse).all()
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)


SPLASH_FWD_SHAPES = [
    (4, 12, 256, 64, True),    # the V33 micro-batch's length, packed rows
    (4, 12, 256, 0, True),
    (2, 12, 512, 64, False),   # the MLM row
    (2, 12, 512, 0, False),
    (3, 4, 200, 64, True),     # ragged last tile
    (3, 4, 200, 0, False),
]


@pytest.mark.parametrize("B,N,S,hw,packed", SPLASH_FWD_SHAPES)
def test_splash_forward_matches_plain_and_repeats_bitwise(cuda, B, N, S, hw,
                                                          packed):
    """The forward alone on strided q, k, v views: out within 2^-7 of its
    largest value, lse within 1e-4 at every row (the fully padded one
    included), and a repeat bitwise equal."""
    q, k, v, seg, _ = _splash_case(B, N, S, 64, packed, 7 * S + hw, cuda)
    assert not q.is_contiguous() and not v.is_contiguous()
    before = sa.splash_attention.launches
    out, lse = sa.splash_attention_forward(q, k, v, seg, hw)
    torch.cuda.synchronize()
    assert sa.splash_attention.launches == before + 1
    out_p, lse_p = sa.splash_attention_plain(q, k, v, seg, hw)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel(out, out_p) <= SPLASH_RTOL, _rel(out, out_p)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=1e-4)
    out2, lse2 = sa.splash_attention_forward(q, k, v, seg, hw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("B,N,S,hw,packed", SPLASH_SHAPES[1:4])
def test_splash_backward_writes_bf16_as_the_cast_of_f32(cuda, B, N, S, hw,
                                                       packed):
    """A gradient asked in bf16 is the f32 one rounded to nearest, bitwise,
    in every mix of the three dtypes; delta does not depend on them."""
    q, k, v, seg, d_out = _splash_case(B, N, S, 64, packed, S, cuda)
    f32, bf16 = torch.float32, torch.bfloat16
    out, lse = sa.splash_attention_forward(q, k, v, seg, hw)
    dq, delta = sa.splash_attention_bwd_dq(q, k, v, seg, hw, d_out, out, lse,
                                           f32)
    dk, dv = sa.splash_attention_bwd_dkv(q, k, v, seg, hw, d_out, lse, delta,
                                         f32, f32)
    dq16, delta16 = sa.splash_attention_bwd_dq(q, k, v, seg, hw, d_out, out,
                                               lse, bf16)
    assert dq16.dtype == bf16 and torch.equal(dq16, dq.to(bf16))
    assert torch.equal(delta16, delta)
    for dtk, dtv in ((bf16, bf16), (bf16, f32), (f32, bf16)):
        gk, gv = sa.splash_attention_bwd_dkv(q, k, v, seg, hw, d_out, lse,
                                             delta, dtk, dtv)
        assert (gk.dtype, gv.dtype) == (dtk, dtv)
        assert torch.equal(gk, dk.to(dtk)) and torch.equal(gv, dv.to(dtv))
    # delta alone: the dq kernel launches, writes delta and no dq
    before = sa.splash_attention_bwd_dq.launches
    none, delta_only = sa.splash_attention_bwd_dq(q, k, v, seg, hw, d_out,
                                                  out, lse, None)
    assert none is None and torch.equal(delta_only, delta)
    assert sa.splash_attention_bwd_dq.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("need_q", [True, False])
def test_splash_function_gradients_in_operand_dtypes(cuda, dtype, need_q):
    """Through the Function with bf16 or f32 operands, with and without a
    gradient for q: each gradient in its operand's dtype, equal to the
    wrappers' f32 gradients cast to it; without q's, the dq kernel still
    launches (it supplies delta) and dk, dv are unchanged."""
    B, N, S, hw = 3, 4, 200, 64
    q, k, v, seg, d_out = _splash_case(B, N, S, 64, True, 11, cuda, dtype)
    fns = (sa.splash_attention_bwd_dq, sa.splash_attention_bwd_dkv)
    leaves = [t.detach().clone().requires_grad_(need)
              for t, need in zip((q, k, v), (need_q, True, True))]
    out = sa.splash_attention(*leaves, seg, hw)
    before = [fn.launches for fn in fns]
    out.backward(d_out.to(out.dtype))
    assert [fn.launches for fn in fns] == [n + 1 for n in before]
    qb, kb, vb = (t.detach().to(torch.bfloat16) for t in (q, k, v))
    o, lse = sa.splash_attention_forward(qb, kb, vb, seg, hw)
    dq, delta = sa.splash_attention_bwd_dq(qb, kb, vb, seg, hw,
                                           d_out.to(torch.bfloat16), o, lse)
    dk, dv = sa.splash_attention_bwd_dkv(qb, kb, vb, seg, hw,
                                         d_out.to(torch.bfloat16), lse, delta)
    assert (leaves[0].grad is None) == (not need_q)
    for leaf, want in zip(leaves, (dq, dk, dv)):
        if leaf.grad is not None:
            assert leaf.grad.dtype == dtype
            assert torch.equal(leaf.grad, want.transpose(1, 2).to(dtype))


@pytest.mark.parametrize("D", [16, 32, 128])
def test_splash_refuses_a_head_width_it_was_not_built_for(cuda, D):
    q, k, v, seg, d_out = _splash_case(2, 2, 32, D, False, 1, cuda)
    before = sa.splash_attention.launches
    with pytest.raises(ValueError, match=f"head dim {D}"):
        sa.splash_attention(q, k, v, seg, 0)
    with pytest.raises(ValueError, match=f"head dim {D}"):
        sa.splash_attention_bwd_dq(q, k, v, seg, 0, d_out, d_out,
                                   torch.zeros(2, 2, 32, device=cuda))
    with pytest.raises(ValueError, match=f"head dim {D}"):
        sa.splash_attention_bwd_dkv(q, k, v, seg, 0, d_out,
                                    torch.zeros(2, 2, 32, device=cuda),
                                    torch.zeros(2, 2, 32, device=cuda))
    assert sa.splash_attention.launches == before


def test_splash_empty_batch_launches_and_counts_nothing(cuda):
    q, k, v, seg, d_out = _splash_case(2, 2, 32, 64, False, 2, cuda)
    fns = (sa.splash_attention, sa.splash_attention_bwd_dq,
           sa.splash_attention_bwd_dkv)
    before = [fn.launches for fn in fns]
    out, lse = sa.splash_attention_forward(q[:0], k[:0], v[:0], seg[:0], 4)
    assert out.shape == (0, 32, 2, 64) and lse.shape == (0, 2, 32)
    dq, delta = sa.splash_attention_bwd_dq(q[:0], k[:0], v[:0], seg[:0], 4,
                                           d_out[:0], out, lse)
    dk, dv = sa.splash_attention_bwd_dkv(q[:0], k[:0], v[:0], seg[:0], 4,
                                         d_out[:0], lse, delta)
    assert dq.shape == dk.shape == dv.shape == (0, 32, 2, 64)
    assert delta.shape == (0, 2, 32)
    assert [fn.launches for fn in fns] == before


def _function_grads(q, k, v, seg, hw, d_out, wrap=lambda f: f):
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = wrap(lambda a, b, c: sa.splash_attention(a, b, c, seg, hw))(*leaves)
    out.backward(d_out.to(out.dtype))
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("B,N,S,hw,packed", SPLASH_SHAPES[1:5])
def test_splash_repeated_backward_is_bitwise_equal(cuda, B, N, S, hw, packed):
    """One owner and one order per sum, no atomics."""
    case = _splash_case(B, N, S, 64, packed, S, cuda)
    q, k, v, seg, d_out = case
    out1, grads1 = _function_grads(q, k, v, seg, hw, d_out)
    out2, grads2 = _function_grads(q, k, v, seg, hw, d_out)
    assert torch.equal(out1, out2)
    for a, b in zip(grads1, grads2):
        assert torch.equal(a, b)


def test_splash_function_under_autocast_and_checkpoint(cuda):
    """The operands autocast hands over: f32 q and k (RoPE multiplies bf16
    by f32 tables), a strided bf16 v. The gradients come back in those
    dtypes and agree with the plain route's (f32 autograd through the plain
    version on the same bf16 values); under per-layer checkpointing the
    forward runs twice and the gradients are bitwise the same."""
    from torch.utils.checkpoint import checkpoint

    B, N, S, hw = 3, 4, 200, 64
    q, k, v, seg, d_out = _splash_case(B, N, S, 64, True, 9, cuda)
    q, k, d_out = q.float(), k.float(), d_out.float()
    fns = (sa.splash_attention, sa.splash_attention_bwd_dq,
           sa.splash_attention_bwd_dkv)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        before = [fn.launches for fn in fns]
        out, grads = _function_grads(q, k, v, seg, hw, d_out)
        assert [fn.launches for fn in fns] == [n + 1 for n in before]
        out_c, grads_c = _function_grads(
            q, k, v, seg, hw, d_out,
            wrap=lambda f: lambda *a: checkpoint(f, *a, use_reentrant=False))
        assert [fn.launches - n for fn, n in zip(fns, before)] == [3, 2, 2]
    assert out.dtype == torch.float32 and out.shape == (B, S, N, 64)
    assert [g.dtype for g in grads] == [torch.float32, torch.float32,
                                        torch.bfloat16]
    assert [tuple(g.shape) for g in grads] == [(B, N, S, 64)] * 3
    assert torch.equal(out, out_c)
    for a, b in zip(grads, grads_c):
        assert torch.equal(a, b)
    # the plain route on the CPU, f32 autograd through the plain version
    cpu = [t.detach().cpu() for t in (q, k, v.float(), seg, d_out)]
    want_out, want = _function_grads(cpu[0], cpu[1], cpu[2], cpu[3], hw,
                                     cpu[4])
    assert _rel(out.cpu(), want_out) <= SPLASH_RTOL
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        # the saved out is bf16 on the card, so delta carries its rounding
        assert _rel(got.cpu(), ref) <= 2 * SPLASH_RTOL, (name,
                                                         _rel(got.cpu(), ref))


def test_model_on_the_splash_route_matches_the_sdpa_route(cuda):
    """A narrow ModernBERT with 64-wide heads in bf16 on the card: encode
    through the attention kernels equals the plain attention at the valid
    positions up to bf16 rounding, and is finite at the padded ones."""
    import dataclasses

    from splade_tpu_torch.models.modernbert import ModernBertConfig
    from splade_tpu_torch.models.splade import SpladeEncoder

    cfg = ModernBertConfig.tiny(hidden_size=128, num_attention_heads=2,
                                intermediate_size=192, local_attention=16,
                                attention_impl="splash")
    model = SpladeEncoder(cfg, device=cuda).init_weights(0).to(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 500, (6, 100), generator=g).to(cuda)
    lens = torch.randint(5, 101, (6, 1), generator=g)
    mask = (torch.arange(100)[None] < lens).long().to(cuda)
    before = sa.splash_attention.launches
    with torch.no_grad():
        splash = model.mlm.encode(ids, mask)
        assert sa.splash_attention.launches == before + cfg.num_hidden_layers
        model.mlm.config = dataclasses.replace(cfg, attention_impl="sdpa")
        sdpa = model.mlm.encode(ids, mask)
    assert sa.splash_attention.launches == before + cfg.num_hidden_layers
    assert torch.isfinite(splash).all()
    valid = mask.bool()
    assert _rel(splash[valid], sdpa[valid]) <= 2e-2


# ---- the RoPE kernel pair of the splash route ------------------------------
#: (B, S, tables): the V33 micro-batch (tables gathered by packed positions),
#: the MLM one (tables the batch shares), one odd short row, and two rows of
#: which the second is all padding (position 0 throughout)
ROPE_SHAPES = [(144, 256, "packed"), (32, 512, "shared"), (1, 40, "shared"),
               (2, 40, "packed")]


def _rope_case(B, S, tables, device, N=12, seed=0):
    from splade_tpu_torch.models.modernbert import rope_cos_sin

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, S, 3, N, 64, generator=g).to(torch.bfloat16)
    cos, sin = rope_cos_sin(S, 64, 10000.0)
    if tables == "packed":
        pos = torch.randint(0, S, (B, S), generator=g)
        if B == 2:
            pos[1] = 0
        cos, sin = cos[pos], sin[pos]
    return [t.to(device) for t in (qkv, cos, sin)]


@pytest.mark.parametrize("B,S,tables", ROPE_SHAPES)
def test_rope_forward_is_bitwise_the_cast_of_the_eager_chain(cuda, B, S,
                                                             tables):
    """q and k as the attention was given them before: the eager f32 chain
    (apply_rope on the product's bf16 views, f32 tables) cast to bf16."""
    from splade_tpu_torch.models.modernbert import apply_rope
    from splade_tpu_torch.ops import rope

    qkv, cos, sin = _rope_case(B, S, tables, cuda)
    before = rope.rope_qkv_fwd.launches
    q, k, v = rope.rope_qkv(qkv, cos, sin)
    torch.cuda.synchronize()
    assert rope.rope_qkv_fwd.launches == before + 1
    assert q.is_contiguous() and k.is_contiguous()
    assert q.dtype == k.dtype == torch.bfloat16
    assert v.data_ptr() == qkv[:, :, 2].data_ptr()
    cq, ck, _ = qkv.unbind(2)
    assert torch.equal(q, apply_rope(cq, cos, sin).to(torch.bfloat16))
    assert torch.equal(k, apply_rope(ck, cos, sin).to(torch.bfloat16))
    assert torch.equal(q, rope.rope_qkv_fwd_plain(qkv, cos, sin)[0])


@pytest.mark.parametrize("B,S,tables", ROPE_SHAPES)
def test_rope_backward_within_one_rounding_of_f64(cuda, B, S, tables):
    """The product's gradient from bf16 dq, dk and dv (strided as the
    attention's [B, N, S, D] views hand them back): dq and dk rotated back
    within one bf16 rounding of the f64 rotation, and bitwise its plain
    version; dv copied into its slot bitwise; a repeat bitwise equal."""
    from splade_tpu_torch.ops import rope

    qkv, cos, sin = _rope_case(B, S, tables, cuda, seed=1)
    dq, dk = qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous()
    dv = qkv[:, :, 2]
    before = rope.rope_qkv_bwd.launches
    got = rope.rope_qkv_bwd(dq, dk, dv, cos, sin, torch.bfloat16)
    again = rope.rope_qkv_bwd(dq, dk, dv, cos, sin, torch.bfloat16)
    torch.cuda.synchronize()
    assert rope.rope_qkv_bwd.launches == before + 2
    assert got.shape == (B, S, 3, 12, 64) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    want = rope.rope_qkv_bwd_plain(dq.double(), dk.double(), dv.double(),
                                   cos.double(), sin.double(), torch.float64)
    err = (got.double() - want).abs()
    assert bool((err <= want.abs() * 2.0 ** -8 + 1e-6).all())
    assert torch.equal(got[:, :, 2], dv)
    plain = rope.rope_qkv_bwd_plain(dq, dk, dv, cos, sin, torch.bfloat16)
    assert torch.equal(got, plain)


def test_rope_pair_is_adjoint_and_gradcheck_takes_the_plain_path(cuda):
    """The backward kernel is the transpose of the forward's rotation:
    <R x, g> = <x, R^T g> within the bf16 roundings of both; on an f64
    product on the card the model's route keeps the plain chain, through
    which ``gradcheck`` passes."""
    from splade_tpu_torch.models.modernbert import apply_rope
    from splade_tpu_torch.ops import rope

    qkv, cos, sin = _rope_case(4, 72, "packed", cuda, seed=2)
    gq, gk, _ = _rope_case(4, 72, "packed", cuda, seed=3)[0].unbind(2)
    fwd = rope.rope_qkv_fwd(qkv, cos, sin).double()
    bwd = rope.rope_qkv_bwd(gq, gk, gq, cos, sin, torch.bfloat16).double()
    lhs = float((fwd[0] * gq.double()).sum() + (fwd[1] * gk.double()).sum())
    rhs = float((qkv[:, :, :2].double() * bwd[:, :, :2]).sum())
    scale = float(fwd.abs().sum() + bwd.abs().sum()) / fwd.numel()
    assert abs(lhs - rhs) <= 2.0 ** -8 * scale * fwd[0].numel() ** 0.5 * 4
    small = _rope_case(2, 5, "packed", cuda, N=2, seed=4)
    x = small[0].double().requires_grad_()
    c, s = small[1].double(), small[2].double()
    assert not rope.fused_rope_applies(x, c, s)

    def chain(t):
        q, k, v = t.unbind(2)
        return apply_rope(q, c, s), apply_rope(k, c, s), v

    assert torch.autograd.gradcheck(chain, (x,))


@pytest.mark.parametrize("remat", [False, True])
def test_rope_counters_follow_the_splash_calls(cuda, remat):
    """A narrow encoder with 64-wide heads on the splash route, f32
    parameters under bf16 autocast as training runs it: one RoPE forward a
    splash forward (twice a layer under recompute) and one backward a dq
    kernel; its output bitwise the chain's route and its gradients within
    bf16 rounding of them. Without autocast (f32 q and k) the RoPE
    kernels are not taken, and on the CPU nothing is counted."""
    from splade_tpu_torch.models import modernbert
    from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                    ModernBertForMaskedLM)
    from splade_tpu_torch.ops import rope

    cfg = ModernBertConfig.tiny(hidden_size=128, num_attention_heads=2,
                                intermediate_size=192, local_attention=16,
                                attention_impl="splash", remat=remat)
    torch.manual_seed(0)
    model = ModernBertForMaskedLM(cfg).to(cuda)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 500, (6, 100), generator=g)
    lens = torch.randint(5, 101, (6, 1), generator=g)
    mask = (torch.arange(100)[None] < lens).long()
    fns = (rope.rope_qkv_fwd, rope.rope_qkv_bwd, sa.splash_attention,
           sa.splash_attention_bwd_dq)

    def run(dev, autocast=True, fused=True):
        real = modernbert.fused_rope_applies
        if not fused:
            modernbert.fused_rope_applies = lambda *a: False
        m = model.to(dev)
        m.zero_grad()
        before = [fn.launches for fn in fns]
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16,
                                enabled=autocast):
                h = m.encode(ids.to(dev), mask.to(dev))
                h.float().square().mean().backward()
        finally:
            modernbert.fused_rope_applies = real
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in m.named_parameters() if p.grad is not None}
        return (h.detach().float().cpu(), grads,
                [fn.launches - n for fn, n in zip(fns, before)])

    L = cfg.num_hidden_layers
    h, grads, counts = run(cuda)
    assert counts == [L * (2 if remat else 1), L, L * (2 if remat else 1), L]
    h_chain, grads_chain, counts_chain = run(cuda, fused=False)
    assert counts_chain == [0, 0, L * (2 if remat else 1), L]
    assert torch.equal(h, h_chain)
    for name, ref in grads_chain.items():
        assert _rel(grads[name], ref) <= 2e-2, (name, _rel(grads[name], ref))
    _, _, counts_f32 = run(cuda, autocast=False)
    assert counts_f32[:2] == [0, 0] and counts_f32[2] > 0
    _, _, counts_cpu = run(torch.device("cpu"))
    assert counts_cpu == [0, 0, 0, 0]


def test_rope_empty_batch_launches_and_counts_nothing(cuda):
    from splade_tpu_torch.ops import rope

    qkv, cos, sin = _rope_case(2, 40, "shared", cuda)
    before = (rope.rope_qkv_fwd.launches, rope.rope_qkv_bwd.launches)
    out = rope.rope_qkv_fwd(qkv[:0], cos, sin)
    g = out[0]
    dqkv = rope.rope_qkv_bwd(g, g, g, cos, sin, torch.bfloat16)
    assert out.shape == (2, 0, 40, 12, 64) and dqkv.shape == (0, 40, 3, 12, 64)
    assert (rope.rope_qkv_fwd.launches, rope.rope_qkv_bwd.launches) == before


# ---- the fused residual add + LayerNorm pair -------------------------------
#: (B, S, H): the V33 micro-batch's rows, the MLM one's, an odd row count,
#: and the smallest and largest widths the kernels are built for
ADD_NORM_SHAPES = [(144, 256, 768), (32, 512, 768), (3, 37, 768),
                   (5, 11, 256), (2, 29, 1024)]
#: form -> (a bf16 branch, n's dtype): a layer's site, the final norm, the
#: embedding's norm
ADD_NORM_FORMS = {"layer": (True, torch.bfloat16),
                  "final": (True, torch.float32),
                  "embedding": (False, torch.float32)}
ADD_NORM_EPS = 1e-5
#: f32 outputs against f64, relative to the tensor's largest value: f32
#: sums of a row (or, for gamma's gradient, of every row) in another order
ADD_NORM_RTOL = 1e-5


def _add_norm_case(B, S, H, form, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(B, S, H, generator=g) * 4.0 + torch.randn(B, S, 1,
                                                             generator=g)
    b = torch.randn(B, S, H, generator=g).to(torch.bfloat16)
    w = 1.0 + 0.1 * torch.randn(H, generator=g)
    dn = torch.randn(B, S, H, generator=g).to(ADD_NORM_FORMS[form][1])
    d_above = torch.randn(B, S, H, generator=g) * 0.1
    if not ADD_NORM_FORMS[form][0]:
        b = d_above = None
    return [None if t is None else t.to(device)
            for t in (r, b, w, dn, d_above)]


def _within_one_bf16_rounding(got, want):
    err = (got.double() - want.double()).abs()
    return bool((err <= want.double().abs() * 2.0 ** -7 + 1e-6).all())


@pytest.mark.parametrize("form", list(ADD_NORM_FORMS))
@pytest.mark.parametrize("B,S,H", ADD_NORM_SHAPES)
def test_add_norm_forward_against_the_eager_chain(cuda, B, S, H, form):
    """r' bitwise the eager mixed add; n within one bf16 ulp of the eager
    chain's cast (an f32 n within ADD_NORM_RTOL of the chain's); mean and
    rstd within ADD_NORM_RTOL of the f64 plain version; one launch."""
    import torch.nn.functional as F

    from splade_tpu_torch.ops import add_norm as an

    r, b, w, _, _ = _add_norm_case(B, S, H, form, cuda)
    n_dtype = ADD_NORM_FORMS[form][1]
    before = an.add_layernorm_fwd.launches
    r_out, n, stats = an.add_layernorm_fwd(r, b, w, ADD_NORM_EPS, n_dtype)
    torch.cuda.synchronize()
    assert an.add_layernorm_fwd.launches == before + 1
    x = r if b is None else r + b
    assert torch.equal(r_out, x)
    chain = F.layer_norm(x, (H,), w, None, ADD_NORM_EPS).to(n_dtype)
    assert n.dtype == n_dtype
    if n_dtype == torch.bfloat16:
        assert _within_one_bf16_rounding(n, chain)
    else:
        assert _rel(n, chain) <= ADD_NORM_RTOL
    _, _, st64 = an.add_layernorm_fwd_plain(x.double(), None, w.double(),
                                            ADD_NORM_EPS, torch.float64)
    assert _rel(stats[0], st64[0]) <= ADD_NORM_RTOL
    assert _rel(stats[1], st64[1]) <= ADD_NORM_RTOL


@pytest.mark.parametrize("form", list(ADD_NORM_FORMS))
@pytest.mark.parametrize("B,S,H", ADD_NORM_SHAPES)
def test_add_norm_backward_against_its_plain_version(cuda, B, S, H, form):
    """dr and gamma's gradient within ADD_NORM_RTOL of the f64 plain
    backward, db bitwise dr's cast to bf16, a repeat bitwise equal; and
    against autograd through the eager chain from the same cotangents."""
    import torch.nn.functional as F

    from splade_tpu_torch.ops import add_norm as an

    r, b, w, dn, d_above = _add_norm_case(B, S, H, form, cuda, seed=1)
    branch_dtype = None if b is None else torch.bfloat16
    r_out, n, stats = an.add_layernorm_fwd(r, b, w, ADD_NORM_EPS, dn.dtype)
    before = an.add_layernorm_bwd.launches
    got = an.add_layernorm_bwd(dn, r_out, stats, w, d_above, branch_dtype)
    again = an.add_layernorm_bwd(dn, r_out, stats, w, d_above, branch_dtype)
    torch.cuda.synchronize()
    assert an.add_layernorm_bwd.launches == before + 2
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    dr, db, dw = got
    want = an.add_layernorm_bwd_plain(
        dn.double(), r_out.double(), stats.double(), w.double(),
        None if d_above is None else d_above.double(), None)
    assert dr.dtype == dw.dtype == torch.float32
    assert _rel(dr, want[0]) <= ADD_NORM_RTOL
    assert _rel(dw, want[2]) <= ADD_NORM_RTOL
    assert (db is None) == (b is None)
    if db is not None:
        assert torch.equal(db, dr.to(torch.bfloat16))
    leaves = [t.detach().requires_grad_() for t in (r, w)] + (
        [] if b is None else [b.detach().requires_grad_()])
    x = leaves[0] if b is None else leaves[0] + leaves[2]
    chain = F.layer_norm(x, (H,), leaves[1], None, ADD_NORM_EPS).to(dn.dtype)
    outs, cots = (([chain], [dn]) if b is None
                  else ([x, chain], [d_above, dn]))
    grads = torch.autograd.grad(outs, leaves, cots)
    assert _rel(dr, grads[0]) <= 2 * ADD_NORM_RTOL
    assert _rel(dw, grads[1]) <= 2 * ADD_NORM_RTOL
    if db is not None:
        assert _within_one_bf16_rounding(db, grads[2])


def test_add_norm_empty_batch_launches_and_counts_nothing(cuda):
    from splade_tpu_torch.ops import add_norm as an

    r, b, w, dn, d_above = _add_norm_case(2, 5, 768, "layer", cuda)
    before = (an.add_layernorm_fwd.launches, an.add_layernorm_bwd.launches)
    r_out, n, stats = an.add_layernorm_fwd(r[:0], b[:0], w, ADD_NORM_EPS,
                                           torch.bfloat16)
    dr, db, dw = an.add_layernorm_bwd(dn[:0], r_out, stats, w, d_above[:0],
                                      torch.bfloat16)
    assert n.shape == dr.shape == db.shape == (0, 5, 768)
    assert torch.equal(dw, torch.zeros_like(dw))
    assert (an.add_layernorm_fwd.launches,
            an.add_layernorm_bwd.launches) == before


def test_add_norm_counters_follow_the_sites(cuda):
    """One V33 micro-batch (144 rows of 256, the 22-layer encoder at 768)
    under layer recompute and bf16 autocast, as training runs it: the
    forward launched once a site (the embedding's norm and the 2 L residual
    adds with their norms) and again for the 2 L - 1 sites inside the
    layers, the backward once a site; finite output and gradients, near the
    eager route's."""
    from splade_tpu_torch.models import modernbert
    from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                    ModernBertForMaskedLM)
    from splade_tpu_torch.ops import add_norm as an

    cfg = ModernBertConfig(remat=True, attention_impl="splash")
    torch.manual_seed(0)
    model = ModernBertForMaskedLM(cfg).to(cuda)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, cfg.vocab_size - 1, (144, 256), generator=g)
    lens = torch.randint(64, 257, (144, 1), generator=g)
    mask = (torch.arange(256)[None] < lens).long()

    def run(fused=True):
        real = modernbert.fused_add_norm_applies
        if not fused:
            modernbert.fused_add_norm_applies = lambda *a: False
        model.zero_grad()
        before = (an.add_layernorm_fwd.launches,
                  an.add_layernorm_bwd.launches)
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                h = model.encode(ids.to(cuda), mask.to(cuda))
                (h.float().square().mean() * 1e3).backward()
        finally:
            modernbert.fused_add_norm_applies = real
        torch.cuda.synchronize()
        grads = torch.cat([p.grad.detach().float().flatten()
                           for p in model.parameters() if p.grad is not None])
        return (h.detach().float(), grads,
                (an.add_layernorm_fwd.launches - before[0],
                 an.add_layernorm_bwd.launches - before[1]))

    L = cfg.num_hidden_layers
    sites, inner = 2 * L + 1, 2 * L - 1
    h, grads, counts = run()
    assert counts == (sites + inner, sites)
    assert h.dtype == torch.float32
    assert bool(torch.isfinite(h).all()) and bool(torch.isfinite(grads).all())
    h_eager, grads_eager, counts_eager = run(fused=False)
    assert counts_eager == (0, 0)
    assert _rel(h, h_eager) <= 2e-2
    assert float((grads - grads_eager).norm()
                 / grads_eager.norm()) <= 5e-2


def test_add_norm_takes_only_autocast_training(cuda):
    """A narrow encoder at H = 256, 4 layers: under bf16 autocast every
    LayerNorm site takes the kernels and the output and gradients lie
    within bf16 rounding of the eager route's; f32 without autocast and
    bf16 serving (bf16 parameters, no autocast) keep the eager chain, as
    does the CPU."""
    from splade_tpu_torch.models import modernbert
    from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                    ModernBertForMaskedLM)
    from splade_tpu_torch.ops import add_norm as an

    cfg = ModernBertConfig.tiny(hidden_size=256, num_attention_heads=4,
                                intermediate_size=384, local_attention=16)
    torch.manual_seed(0)
    model = ModernBertForMaskedLM(cfg)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(3, 500, (6, 100), generator=g)
    lens = torch.randint(5, 101, (6, 1), generator=g)
    mask = (torch.arange(100)[None] < lens).long()

    def run(dev, dtype=torch.float32, autocast=True, fused=True):
        real = modernbert.fused_add_norm_applies
        if not fused:
            modernbert.fused_add_norm_applies = lambda *a: False
        m = model.to(dev, dtype)
        m.zero_grad()
        before = (an.add_layernorm_fwd.launches,
                  an.add_layernorm_bwd.launches)
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16,
                                enabled=autocast):
                h = m.encode(ids.to(dev), mask.to(dev))
                h.float().square().mean().backward()
        finally:
            modernbert.fused_add_norm_applies = real
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in m.named_parameters() if p.grad is not None}
        return (h.detach().float().cpu(), grads,
                (an.add_layernorm_fwd.launches - before[0],
                 an.add_layernorm_bwd.launches - before[1]))

    sites = 2 * cfg.num_hidden_layers + 1
    h, grads, counts = run(cuda)
    assert counts == (sites, sites)
    h_eager, grads_eager, counts_eager = run(cuda, fused=False)
    assert counts_eager == (0, 0)
    assert _rel(h, h_eager) <= 2e-2
    for name, ref in grads_eager.items():
        assert _rel(grads[name], ref) <= 5e-2, (name, _rel(grads[name], ref))
    assert run(cuda, autocast=False)[2] == (0, 0)
    assert run(cuda, torch.bfloat16, autocast=False)[2] == (0, 0)
    assert run(torch.device("cpu"))[2] == (0, 0)
