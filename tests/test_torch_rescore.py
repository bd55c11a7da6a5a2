"""The port's phase-2 rescore (splade_tpu_torch.ops.rescore_kernel and the
plain phase 2 of ops.postings_index) against splade_tpu's ``rescore_match``,
``rescore_match_rows`` (Pallas, interpret mode) and ``exact_rescore``.

All are exact f32 sums of the same products in different orders: atol 1e-4,
the tolerance of tests/test_rescore_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.ops.postings_index import exact_rescore as jax_exact
from splade_tpu.ops.postings_index import sparse_query_dense as jax_qd
from splade_tpu.ops.rescore_kernel import rescore_match as jax_match
from splade_tpu.ops.rescore_kernel import rescore_match_rows as jax_rows
from splade_tpu_torch.ops.postings_index import (dispatch_rescore,
                                                 exact_rescore,
                                                 resolve_rescore_mode,
                                                 sparse_query_dense)
from splade_tpu_torch.ops.rescore_kernel import (rescore_match,
                                                 rescore_match_plain,
                                                 rescore_match_rows)

ATOL = 1e-4


def make_case(seed, N=300, M=16, V=700, B=8, T=12, C=50):
    rng = np.random.default_rng(seed)
    d_terms = np.full((N, M), V, np.int32)           # pad id V
    d_vals = np.zeros((N, M), np.int8)
    for i in range(N):
        nnz = int(rng.integers(0, M + 1))
        if nnz:
            d_terms[i, :nnz] = rng.choice(V, nnz, replace=False)
            d_vals[i, :nnz] = rng.integers(1, 127, nnz)
    d_scale = rng.uniform(0.01, 0.1, N).astype(np.float32)
    q_idx = np.zeros((B, T), np.int32)
    q_val = np.zeros((B, T), np.float32)               # pad slots: val 0
    for b in range(B):
        t = int(rng.integers(2, T + 1))
        q_idx[b, :t] = rng.choice(V, t, replace=False)
        q_val[b, :t] = rng.uniform(0.1, 2.0, t)
        q_idx[b, 1] = q_idx[b, 0]                      # duplicate term
    cand = rng.integers(0, N, (B, C)).astype(np.int32)
    return d_terms, d_vals, d_scale, q_idx, q_val, cand, V


def _jax_ref(d_terms, d_vals, d_scale, q_idx, q_val, cand, V):
    qd = jax_qd(jnp.asarray(q_idx), jnp.asarray(q_val), V)
    return np.asarray(jax_exact(jnp.asarray(d_terms), jnp.asarray(d_vals),
                                jnp.asarray(d_scale), qd, jnp.asarray(cand)))


@pytest.mark.parametrize("shape", [
    dict(),                      # aligned to the TPU tiles
    dict(B=5, C=37),             # B and C not aligned
    dict(M=13, T=7, B=3, C=129),
])
def test_rescore_matches_jax(shape):
    d_terms, d_vals, d_scale, q_idx, q_val, cand, V = make_case(
        sum(shape.values()), **shape)
    args_np = (d_terms, d_vals, d_scale, q_idx, q_val, cand)
    ref = _jax_ref(*args_np, V)
    j_match = np.asarray(jax_match(*(jnp.asarray(x) for x in args_np)))
    j_rows = np.asarray(jax_rows(*(jnp.asarray(x) for x in args_np)))
    args = [torch.from_numpy(x) for x in args_np]
    qd = sparse_query_dense(args[3], args[4], V)
    outs = {
        "rescore_match": rescore_match(*args),
        "rescore_match_rows": rescore_match_rows(*args),
        "plain": rescore_match_plain(*args),
        "exact_rescore": exact_rescore(args[0], args[1], args[2], qd, args[5]),
    }
    for name, out in outs.items():
        for want in (ref, j_match, j_rows):
            np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ATOL,
                                       err_msg=name)
    # duplicate query terms accumulated (not deduplicated)
    assert np.any(outs["plain"].numpy() > 0)


def test_sparse_query_dense_matches_jax():
    *_, q_idx, q_val, _, V = make_case(9)
    want = np.asarray(jax_qd(jnp.asarray(q_idx), jnp.asarray(q_val), V))
    got = sparse_query_dense(torch.from_numpy(q_idx),
                             torch.from_numpy(q_val), V)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert np.all(got.numpy()[:, V] == 0)  # the pad column stays zero


@pytest.mark.parametrize("mode", ["gather", "match"])
@pytest.mark.parametrize("shape", [dict(), dict(B=5, C=37, T=9)])
def test_dispatch_modes_agree(mode, shape):
    d_terms, d_vals, d_scale, q_idx, q_val, cand, V = make_case(11, **shape)
    ref = _jax_ref(d_terms, d_vals, d_scale, q_idx, q_val, cand, V)
    got = dispatch_rescore(*(torch.from_numpy(x) for x in
                             (d_terms, d_vals, d_scale, q_idx, q_val, cand)),
                           V, mode=mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_resolve_rescore_mode(monkeypatch):
    monkeypatch.delenv("SPLADE_RESCORE", raising=False)
    assert resolve_rescore_mode("auto", torch.device("cpu")) == "gather"
    assert resolve_rescore_mode("auto", torch.device("cuda")) == "match"
    assert resolve_rescore_mode("match", torch.device("cpu")) == "match"
    with pytest.raises(ValueError):
        resolve_rescore_mode("match_xla", torch.device("cuda"))
    monkeypatch.setenv("SPLADE_RESCORE", "gather")
    assert resolve_rescore_mode("auto", torch.device("cuda")) == "gather"
    monkeypatch.setenv("SPLADE_RESCORE", "match_rows")   # not a mode: ignored
    assert resolve_rescore_mode("auto", torch.device("cuda")) == "match"


def test_rescore_kernel_wrapper_counts_only_launches():
    d_terms, d_vals, d_scale, q_idx, q_val, cand, _ = make_case(12)
    before = rescore_match.launches
    rescore_match(*(torch.from_numpy(x) for x in
                    (d_terms, d_vals, d_scale, q_idx, q_val, cand)))
    assert rescore_match.launches == before  # the CPU runs the plain version
