"""The port's ModernBERT (splade_tpu_torch.models) against splade_tpu's.

The same numpy-made parameters go into both models: the JAX tree through
``params_from_jax`` into the port. Hidden states and MLM logits must agree
in f32 within 1e-4 (only the order of f32 sums differs), with padded rows
and with packed positions/segment ids. A last check loads the port's state
dict into transformers' own ModernBertForMaskedLM.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.modernbert import ModernBertForMaskedLM as JaxMLM
from splade_tpu_torch.models.hf_port import (params_from_jax,
                                             strip_wrapper_prefix)
from splade_tpu_torch.models.modernbert import (ModernBertConfig,
                                                ModernBertForMaskedLM)

TOL = dict(rtol=1e-4, atol=1e-4)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def make_pair(layers: int, seed: int = 0):
    """(jax model, jax params, port model) sharing perturbed weights."""
    kw = dict(num_hidden_layers=layers)
    jcfg = JaxConfig.tiny(**kw)
    jmodel = JaxMLM(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), ids,
                                  jnp.ones_like(ids))
    rng = np.random.default_rng(seed)
    # perturb everything (unit norms, zero bias) so a mis-mapped tensor shows
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(0, 0.05, np.shape(x)).astype(np.float32),
        _numpy_tree(params["params"]))
    tmodel = ModernBertForMaskedLM(ModernBertConfig.tiny(**kw))
    tmodel.load_state_dict(params_from_jax({"mlm": params}))
    return jmodel, params, tmodel.eval()


def _inputs(seed, B=3, S=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, (B, S)).astype(np.int64)
    lens = rng.integers(S // 2, S + 1, B)
    lens[0] = S
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int64)
    return np.where(mask > 0, ids, 511), mask


@pytest.mark.parametrize("layers", [4, 6])
def test_encode_and_logits_match_jax(layers):
    jmodel, params, tmodel = make_pair(layers)
    ids, mask = _inputs(layers)
    j_ids, j_mask = jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32)
    j_hidden = jax.jit(partial(jmodel.apply, method=jmodel.encode))(
        {"params": params}, j_ids, j_mask)
    j_logits = jax.jit(jmodel.apply)({"params": params}, j_ids, j_mask)
    with torch.no_grad():
        t_hidden = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask))
        t_logits = tmodel(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(j_hidden), **TOL)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **TOL)


def test_packed_positions_and_segments_match_jax():
    jmodel, params, tmodel = make_pair(6, seed=1)
    B, S, pack = 2, 24, 3
    ids, mask = _inputs(7, B, S)
    mask[1, 20:] = 0  # a padded tail inside the last segment
    positions = np.tile(np.arange(S // pack), pack)[None].repeat(B, 0)
    segments = np.repeat(np.arange(pack), S // pack)[None].repeat(B, 0)
    j = jax.jit(partial(jmodel.apply, method=jmodel.encode))(
        {"params": params}, jnp.asarray(ids, jnp.int32),
        jnp.asarray(mask, jnp.int32),
        positions=jnp.asarray(positions, jnp.int32),
        segment_ids=jnp.asarray(segments, jnp.int32))
    with torch.no_grad():
        t = tmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                          positions=torch.from_numpy(positions),
                          segment_ids=torch.from_numpy(segments))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_head_transform_and_decoder_weights_match_jax():
    jmodel, params, tmodel = make_pair(4, seed=2)
    h = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    j = jmodel.apply({"params": params}, jnp.asarray(h),
                     method=jmodel.head_transform)
    emb, bias = tmodel.decoder_weights()
    with torch.no_grad():
        t = tmodel.head_transform(torch.from_numpy(h))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_array_equal(emb.detach().numpy(),
                                  params["tok_embeddings"]["embedding"])
    np.testing.assert_array_equal(bias.detach().numpy(), params["decoder_bias"])


def test_strip_wrapper_prefix():
    state = {"embeddings.norm.weight": 1, "layers.0.attn.Wo.weight": 2,
             "head.dense.weight": 3, "decoder.bias": 4}
    assert sorted(strip_wrapper_prefix(state)) == [
        "decoder.bias", "head.dense.weight", "model.embeddings.norm.weight",
        "model.layers.0.attn.Wo.weight"]
    assert strip_wrapper_prefix({"model.x": 1}) == {"model.x": 1}


def test_state_dict_loads_into_transformers():
    pytest.importorskip("transformers")
    from transformers import ModernBertConfig as HFConfig
    from transformers.models.modernbert.modeling_modernbert import (
        ModernBertForMaskedLM as HFModel)

    _, _, tmodel = make_pair(4, seed=3)
    hf = HFModel(HFConfig(
        vocab_size=512, hidden_size=64, intermediate_size=96,
        num_hidden_layers=4, num_attention_heads=4,
        global_attn_every_n_layers=3, local_attention=8,
        global_rope_theta=160000.0, local_rope_theta=10000.0,
        max_position_embeddings=128, pad_token_id=511,
        attn_implementation="sdpa", reference_compile=False)).eval()
    hf.load_state_dict(tmodel.state_dict(), strict=True)
    ids, mask = _inputs(4)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids),
                  attention_mask=torch.from_numpy(mask)).logits.numpy()
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)  # HF's padded rows depend on its unpadding
    assert np.abs(got - want)[valid].max() < 2e-4
