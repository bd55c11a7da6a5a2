"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here carries the ``gpu`` marker and skips where there is
no CUDA device: a CUDA kernel has no CPU mode. The file imports neither JAX
nor ``splade_tpu``, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from splade_tpu_torch.ops.fused_splade import (fused_splade_pool,
                                               fused_splade_pool_plain)
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
