"""The port's SPLADE pooling (splade_tpu_torch.ops.fused_splade / splade_pool
and models.splade) against splade_tpu's on the same numpy inputs.

On a CPU tensor ``fused_splade_pool`` runs its plain versions, forward and
backward; JAX's runs the Pallas kernels (custom VJP) in interpret mode.
Both are f32 here, so values agree within 1e-5 and gradients within the
JAX package's own 1e-4. The kernels themselves are held against the plain
versions on the card (tests/test_torch_kernels_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu.ops.fused_splade import fused_splade_pool as jax_fused
from splade_tpu.ops.splade_pool import splade_pool_from_logits as jax_from_logits
from splade_tpu.ops.splade_pool import splade_pool_streamed as jax_streamed
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.ops.fused_splade import (PLAIN_TILE, dh_splits,
                                               dh_vocab_splits_v2,
                                               float_from_key, float_key,
                                               fold_cotangent,
                                               fused_splade_bwd_dh,
                                               fused_splade_bwd_dw,
                                               fused_splade_bwd_match,
                                               fused_splade_bwd_match_plain,
                                               fused_splade_bwd_plain,
                                               fused_splade_gather_dh,
                                               fused_splade_gather_dh_plain,
                                               fused_splade_gather_dw,
                                               fused_splade_gather_dw_plain,
                                               fused_splade_pool,
                                               fused_splade_pool_plain,
                                               match_words)
from splade_tpu_torch.ops.splade_pool import (masked_scores,
                                              splade_pool_from_logits,
                                              splade_pool_streamed)

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, B=3, S=10, H=32, V=700):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=V) * 0.1).astype(np.float32)
    lens = rng.integers(1, S + 1, B)
    lens[-1] = 0  # a fully padded row
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return h, w, bias, mask


@pytest.mark.parametrize("V", [700, 512, 37])  # ragged / exact / < one tile
def test_fused_pool_matches_jax_kernel_and_streamed(V):
    h, w, bias, mask = _case(V, V=V)
    j_pool, j_tw = jax_fused(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
                             jnp.asarray(mask))
    s_pool, s_tw = jax_streamed(jnp.asarray(h), jnp.asarray(w),
                                jnp.asarray(bias), jnp.asarray(mask), tile=V)
    t_pool, t_tw = fused_splade_pool(*(torch.from_numpy(x)
                                       for x in (h, w, bias, mask)))
    for want_pool, want_tw in ((j_pool, j_tw), (s_pool, s_tw)):
        np.testing.assert_allclose(t_pool.numpy(), np.asarray(want_pool), **TOL)
        np.testing.assert_allclose(t_tw.numpy(), np.asarray(want_tw), **TOL)
    assert np.all(t_pool.numpy()[-1] == 0) and np.all(t_tw.numpy()[-1] == 0)


def test_fused_pool_without_bias_matches_jax():
    h, w, _, mask = _case(3)
    j_pool, j_tw = jax_fused(jnp.asarray(h), jnp.asarray(w), None,
                             jnp.asarray(mask))
    t_pool, t_tw = fused_splade_pool(torch.from_numpy(h), torch.from_numpy(w),
                                     None, torch.from_numpy(mask))
    np.testing.assert_allclose(t_pool.numpy(), np.asarray(j_pool), **TOL)
    np.testing.assert_allclose(t_tw.numpy(), np.asarray(j_tw), **TOL)


@pytest.mark.parametrize("tile,with_tw", [(700, True), (128, True),
                                          (100, False)])
def test_streamed_and_logits_pools_match_jax(tile, with_tw):
    h, w, bias, mask = _case(tile)
    logits = h @ w.T + bias
    j_ref = jax_from_logits(jnp.asarray(logits), jnp.asarray(mask))
    t_ref = splade_pool_from_logits(torch.from_numpy(logits),
                                    torch.from_numpy(mask))
    j_str = jax_streamed(jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias),
                         jnp.asarray(mask), tile=tile,
                         with_token_weights=with_tw)
    t_str = splade_pool_streamed(*(torch.from_numpy(x)
                                   for x in (h, w, bias, mask)),
                                 tile=tile, with_token_weights=with_tw)
    for t, j in ((t_ref, j_ref), (t_str, j_str)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), **TOL)
        np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), **TOL)


def _grad_case(seed=42, B=3, S=16, H=32, V=300):
    """tests/test_fused_splade.py's inputs: V not a tile multiple, ragged
    lengths; the last row fully padded here too."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = rng.normal(size=(V, H)).astype(np.float32) * 0.3
    bias = rng.normal(size=(V,)).astype(np.float32) * 0.1
    lengths = rng.integers(S // 2, S + 1, size=(B,))
    lengths[-1] = 0
    mask = (np.arange(S)[None] < lengths[:, None]).astype(np.int32)
    return h, w, bias, mask


def _jax_grads(pool, h, w, bias, mask):
    def loss(h_, w_, b_):
        p, _ = pool(h_, w_, b_, jnp.asarray(mask))
        return jnp.sum(jnp.sin(p) * p)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias))]


def _port_grads(pool, h, w, bias, mask):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (h, w, bias)]
    p, tw = pool(*leaves, torch.from_numpy(mask))
    assert not tw.requires_grad  # token weights carry no gradient
    (torch.sin(p) * p).sum().backward()
    return [t.grad.numpy() for t in leaves]


GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def test_fused_pool_grad_matches_jax_pallas_vjp():
    """dh, dW, dbias of the port's autograd.Function (plain backward on the
    CPU) against the Pallas custom VJP in interpret mode and against the
    reference-shaped logits path."""
    case = _grad_case()
    want = _jax_grads(lambda *a: jax_fused(*a, 128), *case)
    ref = _jax_grads(lambda h, w, b, m: jax_from_logits(
        jnp.einsum("bsh,vh->bsv", h, w) + b, m), *case)
    got = _port_grads(fused_splade_pool, *case)
    for g, j, r, name in zip(got, want, ref, ("dh", "dw", "dbias")):
        np.testing.assert_allclose(g, j, **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g, r, **GRAD_TOL, err_msg=name)
    assert np.isfinite(got[0]).all()
    assert np.abs(got[0][-1]).max() == 0.0  # the fully padded row


def test_fused_pool_ties_get_duplicate_gradient_as_jax():
    """Two identical valid positions tie in every column: the kernel's
    semantics (and Pallas's) give each the full gradient, where autograd
    through amax (the streamed path) splits it."""
    h, w, bias, mask = _grad_case(seed=3)
    h[0, 1] = h[0, 0]  # exact ties in row 0
    mask[0, :2] = 1
    want = _jax_grads(lambda *a: jax_fused(*a, 128), h, w, bias, mask)
    got = _port_grads(fused_splade_pool, h, w, bias, mask)
    for g, j, name in zip(got, want, ("dh", "dw", "dbias")):
        np.testing.assert_allclose(g, j, **GRAD_TOL, err_msg=name)
    np.testing.assert_array_equal(got[0][0, 0], got[0][0, 1])
    split = _port_grads(lambda *a: splade_pool_streamed(*a, tile=128),
                        h, w, bias, mask)
    np.testing.assert_allclose(split[0][0, 0] * 2, got[0][0, 0], rtol=1e-4,
                               atol=1e-5)


def test_fused_pool_grad_agrees_with_streamed_paths():
    """Without ties, the port's streamed path (autograd) and JAX's give the
    kernel route's gradient."""
    case = _grad_case(seed=4)
    got = _port_grads(fused_splade_pool, *case)
    streamed = _port_grads(lambda *a: splade_pool_streamed(*a, tile=60),
                           *case)
    j_streamed = _jax_grads(lambda *a: jax_streamed(*a, tile=60), *case)
    for g, s_, j in zip(got, streamed, j_streamed):
        np.testing.assert_allclose(g, s_, **GRAD_TOL)
        np.testing.assert_allclose(s_, j, **GRAD_TOL)


def test_backward_wrappers_on_cpu_are_the_plain_version():
    """On CPU tensors the dh/dW wrappers return the plain backward's halves
    and count no launch; grads come back in the dtypes of h and w."""
    h, w, bias, mask = (torch.from_numpy(x) for x in _grad_case(seed=5))
    m, _ = fused_splade_pool_plain(h, w, bias, mask)
    g_pre = (m > 0).float()
    assert torch.equal(fold_cotangent(1 + m, m)[m > 0].round(), g_pre[m > 0])
    before = (fused_splade_bwd_dh.launches, fused_splade_bwd_dw.launches)
    dh, dw = fused_splade_bwd_plain(h, w, bias, mask, m, g_pre)
    assert torch.equal(fused_splade_bwd_dh(h, w, bias, mask, m, g_pre), dh)
    assert torch.equal(fused_splade_bwd_dw(h, w, bias, mask, m, g_pre), dw)
    assert (fused_splade_bwd_dh.launches,
            fused_splade_bwd_dw.launches) == before
    # g_pre = 1 where m > 0: each such column sends its W row to its argmax
    valid = mask.sum(1) > 0
    want = (w[None] * (m > 0)[:, :, None].float()).sum(1)
    torch.testing.assert_close(dh.sum(1)[valid], want[valid], rtol=1e-5,
                               atol=1e-5)
    hb = h.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    bias_leaf = bias.clone().requires_grad_()
    fused_splade_pool(hb, wb, bias_leaf, mask)[0].sum().backward()
    assert hb.grad.dtype == wb.grad.dtype == torch.bfloat16
    assert bias_leaf.grad.dtype == torch.float32


@pytest.mark.parametrize("B,S,H,hidden,vocab", [
    (128, 256, 768, 1, 4),    # the document batch: 1024 (b, word) rows
    (64, 64, 768, 1, 16),     # the query batch: 128 rows, the most ranges
    (8, 200, 768, 1, 16),     # a ragged last word still counts as a row
    (4, 64, 768, 1, 16),      # never more ranges than MAX_VOCAB_SPLITS
    (1, 16, 64, 1, 16),       # one group: one slice
    (0, 0, 768, 1, 16),       # an empty batch launches nothing; the rule holds
    (128, 256, 1024, 2, 4),   # wider than 768: never a slice wider than that
    (64, 64, 1024, 2, 16),
    (128, 256, 2048, 3, 4),
])
def test_dh_splits_of_the_routed_backward(B, S, H, hidden, vocab):
    """Both kernel families' dh gather takes one rule at V = 50,000: the
    fewest whole 128-column slices of the hidden width (one up to 768, none
    wider than that) and ordered vocab ranges where word rows are few, the
    ranges' partials added in order."""
    V = 50_000
    assert dh_splits(B, S, H, V) == (hidden, vocab)
    assert vocab == dh_vocab_splits_v2(B, S, V)
    groups = -(-H // 128)
    assert 1 <= hidden <= groups
    slice_cols = -(-groups // hidden) * 128
    assert -(-H // slice_cols) == hidden  # every slice holds columns
    assert min(slice_cols, H) <= 768


def _bitmask_case(seed, B, S, H, V):
    """Small-integer h and W (exact f32 scores, many exact ties), ragged
    lengths and a fully padded last row, g_pre from the plain forward's
    maxima with every 7th column set to 0, plus two explicit ties: a
    repeated position, and a repeat across a 32-position word boundary."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-2, 3, (B, S, H)).astype(np.float32)
    w = rng.integers(-2, 3, (V, H)).astype(np.float32)
    bias = rng.integers(-2, 3, V).astype(np.float32)
    lens = rng.integers(S // 2, S + 1, B)
    lens[0] = S
    lens[-1] = 0
    h[0, 1] = h[0, 0]
    h[0, S - 1] = h[0, 2]
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int64)
    t = [torch.from_numpy(x) for x in (h, w, bias, mask)]
    m, _ = fused_splade_pool_plain(*t)
    gout = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    g_pre = fold_cotangent(gout, m)
    g_pre[:, ::7] = 0.0
    return t, m, gout, g_pre


def _unpack(match, S):
    r = torch.arange(32, dtype=torch.int32)
    bits = (match[:, :, None, :] >> r[None, None, :, None]) & 1
    return bits.reshape(match.shape[0], -1, match.shape[2])[:, :S].bool()


@pytest.mark.parametrize("S,V", [
    (200, 300),               # a ragged last word and a ragged vocab tile
    (64, 300),                # whole words
    (40, PLAIN_TILE + 77),    # a ragged last tile of the plain versions
])
def test_plain_bitmask_is_the_argmax_set(S, V):
    """Bit r of match[b, j, v] is set exactly where valid position 32j + r
    scores m[b, v] and g_pre[b, v] != 0: every exact tie, no invalid or
    padded position, no g = 0 column, nothing past S; the CPU wrapper is
    the plain version and counts no launch."""
    (h, w, bias, mask), m, _, g_pre = _bitmask_case(S + V, 3, S, 16, V)
    before = fused_splade_bwd_match.launches
    match = fused_splade_bwd_match(h, w, bias, mask, m, g_pre)
    assert fused_splade_bwd_match.launches == before
    assert match.dtype == torch.int32
    assert match.shape == (3, match_words(S), V)
    assert torch.equal(match,
                       fused_splade_bwd_match_plain(h, w, bias, mask, m, g_pre))
    valid = mask.bool()[:, :, None]
    scores = masked_scores(h, w, bias, valid, 0, V)
    want = (scores == m[:, None]) & valid & (g_pre[:, None] != 0)
    bits = _unpack(match, S)
    assert torch.equal(bits, want)
    r = torch.arange(32, dtype=torch.int32)
    past = (match[:, -1:, None, :] >> r[None, None, :, None]) & 1
    assert int(past.view(3, 32, V)[:, S - 32 * (match.shape[1] - 1):].sum()) \
        == 0
    assert int(bits[-1].sum()) == 0 and int(bits[:, :, ::7].sum()) == 0
    assert bool(bits[0, 0].eq(bits[0, 1]).all())  # the repeated position
    ties = int((bits.sum(1) > 1).sum())
    assert ties > 0 and bool((bits.sum(1)[g_pre != 0][:-V] >= 1).all())


@pytest.mark.parametrize("S", [200, 64, 40])
def test_plain_gathers_compose_to_the_plain_backward(S):
    """dh and dW gathered from the plain bitmask are fused_splade_bwd_plain
    (its composition) and G @ W, Gᵀ @ h with G the argmax set times g_pre;
    the CPU wrappers are the plain versions."""
    (h, w, bias, mask), m, _, g_pre = _bitmask_case(S, 3, S, 16, 300)
    match = fused_splade_bwd_match_plain(h, w, bias, mask, m, g_pre)
    dh = fused_splade_gather_dh_plain(match, w, g_pre, S)
    dw = fused_splade_gather_dw_plain(match, h, g_pre)
    assert torch.equal(fused_splade_gather_dh(match, w, g_pre, S), dh)
    assert torch.equal(fused_splade_gather_dw(match, h, g_pre), dw)
    want_dh, want_dw = fused_splade_bwd_plain(h, w, bias, mask, m, g_pre)
    assert torch.equal(dh, want_dh) and torch.equal(dw, want_dw)
    G = torch.where(_unpack(match, S), g_pre[:, None], 0.0)
    torch.testing.assert_close(dh, G @ w, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dw, torch.einsum("bsv,bsh->vh", G, h),
                               rtol=1e-6, atol=1e-5)
    assert float(dh[-1].abs().max()) == 0.0  # the fully padded row


@pytest.mark.parametrize("S", [40, 16])
def test_plain_gathers_match_jax_pallas_vjp_with_ties(S):
    """The gathers from the plain bitmask against the Pallas custom VJP in
    interpret mode, on inputs with exact ties (a repeated position, one
    across a word boundary at S = 40): every tied position gets the full
    gradient in both."""
    rng = np.random.default_rng(S)
    B, H, V = 3, 32, 300
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    w = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=V) * 0.1).astype(np.float32)
    h[0, 0] *= 3.0  # positions that hold many maxima, repeated
    h[1, 3] *= 3.0
    h[0, 1] = h[0, 0]
    h[1, S - 1] = h[1, 3]
    lens = np.array([S, S, 0])
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    gout = rng.normal(size=(B, V)).astype(np.float32)

    def loss(h_, w_, b_):
        p, _ = jax_fused(h_, w_, b_, jnp.asarray(mask), 128)
        return jnp.sum(p * jnp.asarray(gout))

    want = [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(bias))]
    t = [torch.from_numpy(x) for x in (h, w, bias, mask)]
    m, _ = fused_splade_pool_plain(*t)
    g_pre = fold_cotangent(torch.from_numpy(gout), m)
    match = fused_splade_bwd_match_plain(*t, m, g_pre)
    got = (fused_splade_gather_dh_plain(match, t[1], g_pre, S),
           fused_splade_gather_dw_plain(match, t[0], g_pre))
    for g, j, name in zip(got, want, ("dh", "dw")):
        np.testing.assert_allclose(g.numpy(), j, **GRAD_TOL, err_msg=name)
    tied = _unpack(match, S)
    assert bool(tied[0, 0].eq(tied[0, 1]).all()) and bool(tied[0, 0].any())
    assert bool(tied[1, 3].eq(tied[1, S - 1]).all()) and bool(tied[1, 3].any())
    np.testing.assert_array_equal(got[0][0, 0].numpy(), got[0][0, 1].numpy())


def test_float_key_orders_like_floats():
    x = torch.tensor([-1e30, -3.5, -0.5, 0.0, 0.25, 7.0, 1e30])
    k = float_key(x)
    assert torch.all(k[1:] > k[:-1])
    assert torch.equal(float_from_key(k), x)


@pytest.fixture(scope="module")
def jax_encoder_case():
    """A tiny JAX SpladeEncoder (the Pallas pool, interpret mode), its
    parameters as numpy, inputs with a padded tail and a fully padded row,
    and its outputs."""
    jmodel = JaxSplade(JaxConfig.tiny(num_hidden_layers=4), pool_impl="pallas")
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids0,
                                  jnp.ones_like(ids0))
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params["params"])
    rng = np.random.default_rng(0)
    params["mlm"]["decoder_bias"] = rng.normal(
        0, 0.5, params["mlm"]["decoder_bias"].shape).astype(np.float32)
    ids = rng.integers(2, 500, (3, 16)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mask[2] = 0
    j_repr, j_tw = jax.jit(jmodel.apply)({"params": params},
                                         jnp.asarray(ids, jnp.int32),
                                         jnp.asarray(mask, jnp.int32))
    return params, ids, mask, np.asarray(j_repr), np.asarray(j_tw)


@pytest.mark.parametrize("pool_impl", ["kernel", "streamed", "logits"])
def test_splade_encoder_matches_jax(jax_encoder_case, pool_impl):
    params, ids, mask, j_repr, j_tw = jax_encoder_case
    tmodel = SpladeEncoder(ModernBertConfig.tiny(num_hidden_layers=4),
                           pool_impl=pool_impl, pool_tile=128, device="cpu")
    tmodel.mlm.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        t_repr, t_tw = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(t_repr.numpy(), j_repr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_tw.numpy(), j_tw, rtol=1e-4, atol=1e-4)
    assert np.all(t_repr.numpy()[2] == 0)
