"""The port's SPLADE pooling (splade_tpu_torch.ops.fused_splade / splade_pool
and models.splade) against splade_tpu's on the same numpy inputs.

On a CPU tensor ``fused_splade_pool`` runs its plain version; JAX's runs the
Pallas kernel in interpret mode. Both are f32 here, so they agree within
1e-5. The kernel itself is held against the plain version on the card
(tests/test_torch_kernels_gpu.py)."""

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
from splade_tpu_torch.ops.fused_splade import (float_from_key, float_key,
                                               fused_splade_pool)
from splade_tpu_torch.ops.splade_pool import (splade_pool_from_logits,
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


def test_fused_pool_refuses_grad():
    h, w, bias, mask = (torch.from_numpy(x) for x in _case(5))
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_splade_pool(h.requires_grad_(), w, bias, mask)
    with torch.no_grad():  # no graph is built: allowed
        fused_splade_pool(h, w, bias, mask)


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
