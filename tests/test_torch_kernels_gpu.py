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
                                               fused_splade_bwd_plain,
                                               fused_splade_maxima,
                                               fused_splade_pool,
                                               fused_splade_pool_plain)
from splade_tpu_torch.ops.fused_splade_v2 import (fused_splade_bwd_dh_v2,
                                                  fused_splade_bwd_dw_v2,
                                                  fused_splade_maxima_v2,
                                                  fused_splade_pool_v2)
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


# ---- the row-blocked family (ops/fused_splade_v2.py) ----------------------
V2_SHAPES = [
    (6, 100, 64, 1000, 3),      # chunks cross batch rows, ragged V, H < 768
    (5, 37, 64, 777, 1),        # ragged everywhere, one row a block
    (8, 64, 768, 50000, 8),     # query width, one row block, 16 vocab splits
    (4, 256, 768, 50000, 2),    # document length
    (64, 64, 768, 50000, 0),    # the training step's query batch (picks 8)
    (128, 256, 768, 50000, 4),  # the training step's documents
]


@pytest.mark.parametrize("B,S,H,V,rb", V2_SHAPES)
def test_v2_forward_equals_v1_bitwise_and_plain(cuda, B, S, H, V, rb):
    """Both families take every score through the same routine, and a
    maximum has no order: the row-blocked m and pos equal the per-row
    kernel's bit for bit. Against the plain version only f32 sum order
    differs."""
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
    tolerance; and its sums have the per-row kernels' owner and order
    (tiles and columns ascending for dh, rows ascending for dW)."""
    case = _bwd_case(B, S, H, V, seed=B * S + V, device=cuda, exact=True)
    dh0, dw0 = fused_splade_bwd_dh_v2.launches, fused_splade_bwd_dw_v2.launches
    got = _kernel_route_v2(*case, rb)
    torch.cuda.synchronize()
    assert (fused_splade_bwd_dh_v2.launches,
            fused_splade_bwd_dw_v2.launches) == (dh0 + 1, dw0 + 1)
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


@pytest.mark.parametrize("H", [64, 200, 768, 1024, 2048])
@pytest.mark.parametrize("rb", [1, 2, 4, 8])
def test_v2_shared_bytes_mirror_equals_the_kernels(cuda, H, rb):
    """``shared_bytes`` mirrors the layout the two ``.cu`` files compute
    for themselves; the launch path asks the built kernels."""
    from splade_tpu_torch.ops import _cuda
    from splade_tpu_torch.ops.fused_splade_v2 import shared_bytes

    lib = _cuda.library()
    assert shared_bytes(H, rb) == max(
        lib.splade_fused_pool_v2_fwd_shared_bytes(H, rb),
        lib.splade_fused_pool_v2_bwd_shared_bytes(H, rb))


def test_v2_refuses_a_hidden_width_its_tile_cannot_hold(cuda):
    h, w, bias, mask = _pool_case(2, 16, 2048, 100, seed=1, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_splade_maxima_v2(h, w, bias, mask, 2)


def test_an_empty_batch_launches_and_counts_nothing(cuda):
    h, w, bias, mask = _pool_case(4, 16, 64, 100, seed=2, device=cuda)
    m, g = torch.zeros(0, 100, device=cuda), torch.ones(0, 100, device=cuda)
    fns = (fused_splade_pool, fused_splade_bwd_dh, fused_splade_bwd_dw,
           fused_splade_pool_v2, fused_splade_bwd_dh_v2,
           fused_splade_bwd_dw_v2)
    before = [fn.launches for fn in fns]
    assert fused_splade_maxima(h[:0], w, bias, mask[:0])[0].shape == (0, 100)
    assert fused_splade_maxima_v2(h[:0], w, bias, mask[:0])[0].shape == (0, 100)
    for dh, dw in ((fused_splade_bwd_dh, fused_splade_bwd_dw),
                   (fused_splade_bwd_dh_v2, fused_splade_bwd_dw_v2)):
        assert dh(h[:0], w, bias, mask[:0], m, g).shape == (0, 16, 64)
        assert float(dw(h[:0], w, bias, mask[:0], m, g).abs().max()) == 0.0
    assert [fn.launches for fn in fns] == before


def _rescore_case(N, M, V, B, T, C, seed, device):
    rng = np.random.default_rng(seed)
    d_terms = np.full((N, M), V, np.int32)
    d_vals = np.zeros((N, M), np.int8)
    nnz = rng.integers(0, M + 1, N)
    for i in range(N):
        d_terms[i, :nnz[i]] = rng.choice(V, nnz[i], replace=False)
        d_vals[i, :nnz[i]] = rng.integers(1, 127, nnz[i])
    d_scale = rng.uniform(0.01, 0.1, N).astype(np.float32)
    q_idx = rng.integers(0, V, (B, T)).astype(np.int32)
    q_idx[:, 1] = q_idx[:, 0]             # duplicate query terms accumulate
    q_val = rng.uniform(0.1, 2.0, (B, T)).astype(np.float32)
    q_val[:, -1] = 0.0                    # a pad query slot
    cand = rng.integers(0, N, (B, C)).astype(np.int64)
    return [torch.from_numpy(x).to(device) for x in
            (d_terms, d_vals, d_scale, q_idx, q_val, cand)]


@pytest.mark.parametrize("N,M,V,B,T,C", [
    (100_000, 64, 50000, 32, 64, 1000),   # the serving shape, vector path
    (500, 13, 700, 5, 12, 37),            # unaligned B, C and M (scalar path)
])
def test_rescore_kernel_matches_plain(cuda, N, M, V, B, T, C):
    case = _rescore_case(N, M, V, B, T, C, seed=N, device=cuda)
    before = rescore_match.launches
    out = rescore_match(*case)
    out_rows = rescore_match_rows(*case)
    ref = rescore_match_plain(*case)
    torch.cuda.synchronize()
    assert rescore_match.launches == before + 2
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(out_rows, ref, rtol=0, atol=1e-4)
