"""The port's packed query tower (SpladeEncoder.forward_packed_qd) against
splade_tpu's and against the port's own unpacked forwards, with gradients
(the cases of tests/test_packed_query.py). f32: differences are reduction
order only, 2e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder, top_k_tokens

TOL = dict(atol=2e-5, rtol=1e-5)


def _toks(rng, n, length, vocab=512, pad_id=511):
    ids = rng.integers(3, vocab - 2, size=(n, length)).astype(np.int32)
    lengths = rng.integers(2, length + 1, size=(n,))
    mask = (np.arange(length)[None] < lengths[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, pad_id), mask


@pytest.fixture(scope="module")
def pair():
    """Sq=8, Sd=32 -> pack 4, as 64/256; local_attention=8 (half-window 4
    < Sq) exercises the window and segment masks together."""
    jmodel = JaxSplade(JaxConfig.tiny(local_attention=8), pool_impl="streamed",
                       pool_tile=128)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32),
        jmodel.init(jax.random.PRNGKey(0), ids0, jnp.ones_like(ids0))["params"])
    rng = np.random.default_rng(0)
    params["mlm"]["decoder_bias"] = rng.normal(
        0, 0.3, params["mlm"]["decoder_bias"].shape).astype(np.float32)
    return jmodel, params


def _port(params, pool_impl):
    model = SpladeEncoder(ModernBertConfig.tiny(local_attention=8),
                          pool_impl=pool_impl, pool_tile=128, device="cpu")
    model.mlm.load_state_dict(params_from_jax(params))
    return model


def _t(*xs):
    return [torch.from_numpy(x.astype(np.int64)) for x in xs]


@pytest.mark.parametrize("pool_impl", ["kernel", "streamed"])
@pytest.mark.parametrize("B", [8, 5])  # 8 % 4 == 0; 5 needs a padded row
def test_packed_matches_jax_and_unpacked(pair, pool_impl, B):
    jmodel, params = pair
    rng = np.random.default_rng(B)
    q_ids, q_mask = _toks(rng, B, 8)
    d_ids, d_mask = _toks(rng, 2 * B, 32)
    (jq, jq_tw), (jd, jd_tw) = jmodel.apply(
        {"params": params}, jnp.asarray(q_ids), jnp.asarray(q_mask),
        jnp.asarray(d_ids), jnp.asarray(d_mask), method="forward_packed_qd")
    model = _port(params, pool_impl)
    with torch.no_grad():
        (tq, tq_tw), (td, td_tw) = model.forward_packed_qd(
            *_t(q_ids, q_mask, d_ids, d_mask))
        uq, uq_tw = model(*_t(q_ids, q_mask))
        ud, ud_tw = model(*_t(d_ids, d_mask))
    for got, want in ((tq, jq), (td, jd), (tq_tw, jq_tw), (td_tw, jd_tw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for got, want in ((tq, uq), (td, ud), (tq_tw, uq_tw), (td_tw, ud_tw)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def _loss(out):
    (q, _), (d, _) = out
    return (q * q).sum() + abs(d).sum()  # jnp and torch alike


@pytest.mark.parametrize("B", [8, 5])
def test_packed_gradients_match_jax_and_unpacked(pair, B):
    jmodel, params = pair
    rng = np.random.default_rng(10 + B)
    q_ids, q_mask = _toks(rng, B, 8)
    d_ids, d_mask = _toks(rng, 2 * B, 32)

    def jax_loss(p):
        return _loss(jmodel.apply({"params": p}, jnp.asarray(q_ids),
                                  jnp.asarray(q_mask), jnp.asarray(d_ids),
                                  jnp.asarray(d_mask),
                                  method="forward_packed_qd"))

    want = params_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jax.grad(jax_loss)(params)))
    packed, unpacked = _port(params, "kernel"), _port(params, "kernel")
    _loss(packed.forward_packed_qd(*_t(q_ids, q_mask, d_ids, d_mask))
          ).backward()
    _loss((unpacked(*_t(q_ids, q_mask)), unpacked(*_t(d_ids, d_mask)))
          ).backward()
    ref = dict(unpacked.mlm.named_parameters())
    for name, p in packed.mlm.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=0, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)
        np.testing.assert_allclose(p.grad.numpy(), ref[name].grad.numpy(),
                                   rtol=0, atol=2e-5 * max(scale, 1.0),
                                   err_msg=name)


def test_rejects_non_multiple_lengths(pair):
    _, params = pair
    rng = np.random.default_rng(2)
    q_ids, q_mask = _toks(rng, 2, 7)
    d_ids, d_mask = _toks(rng, 4, 32)
    with pytest.raises(ValueError, match="multiple"):
        _port(params, "kernel").forward_packed_qd(
            *_t(q_ids, q_mask, d_ids, d_mask))


def test_top_k_tokens_matches_jax():
    from splade_tpu.models.splade import top_k_tokens as jax_top_k

    class Tok:
        def decode(self, ids):
            return f" t{ids[0]} "

    vec = np.zeros(100, np.float32)
    vec[[3, 50, 7, 99]] = [0.5, 2.0, 1.0, 0.25]
    got = top_k_tokens(torch.from_numpy(vec), Tok(), k=3)
    assert got == jax_top_k(jnp.asarray(vec), Tok(), k=3)
    assert list(got) == ["t50", "t7", "t3"]
