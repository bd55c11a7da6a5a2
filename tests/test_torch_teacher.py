"""The port's XLM-R encoder and BGE-M3 teacher against splade_tpu's and HF's.

The same HF state dict goes into HF's ``XLMRobertaModel``, JAX's
``XlmRobertaEncoder`` (``port_xlmr_state_dict``) and the port's (its own
``port_xlmr_state_dict``, and the JAX tree through ``xlmr_state_from_jax``).
In f32 the port's hidden states agree with both within 1e-5, a padded row
included. In bf16 the port follows JAX's order of casts: the two bf16
encoders agree within 2^-7 of the largest hidden value (one bf16 ulp at
that size is 2^-8 of it; the routes round an f32 sum once or twice), while
either is several times further from f32. The teacher's scoring API and
soft labels match JAX's BGEM3Teacher on the same weights and tokenizer,
``kd_loss_with_teacher`` matches JAX's within 1e-6, and ``from_hf_dir``
reads a ``.bin``-only dir and a safetensors dir alike."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from splade_tpu.models import teachers as jax_teachers
from splade_tpu.models import xlmr as jax_xlmr
from splade_tpu_torch.models import teachers, xlmr

torch.set_num_threads(1)

F32_ATOL = 1e-5
#: bf16 port vs bf16 JAX, relative to the largest hidden value
BF16_RTOL = 2.0 ** -7


@pytest.mark.parametrize("ids, pad", [
    ([[5, 6, 7, 1, 1]], 1),
    ([[0, 9, 1, 4, 1], [1, 1, 1, 1, 1]], 1),  # a pad inside, a padded row
    ([[3, 0, 0, 8]], 0)])
def test_roberta_position_ids(ids, pad):
    got = xlmr.roberta_position_ids(torch.tensor(ids), pad).numpy()
    want = np.asarray(jax_xlmr.roberta_position_ids(jnp.asarray(ids), pad))
    np.testing.assert_array_equal(got, want)
    if ids == [[5, 6, 7, 1, 1]]:
        np.testing.assert_array_equal(got, [[2, 3, 4, 1, 1]])


def _hf_model(num_hidden_layers=2, vocab_size=256, max_positions=66):
    from transformers import XLMRobertaConfig as HFConfig, XLMRobertaModel

    hf_cfg = HFConfig(
        vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
        num_hidden_layers=num_hidden_layers, num_attention_heads=4,
        max_position_embeddings=max_positions, type_vocab_size=1,
        pad_token_id=1, hidden_act="gelu", layer_norm_eps=1e-5,
        attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)
    torch.manual_seed(0)
    return XLMRobertaModel(hf_cfg, add_pooling_layer=False).eval()


@pytest.fixture(scope="module")
def xlmr_pair():
    hf = _hf_model()
    cfg = jax_xlmr.XlmRobertaConfig.tiny()
    params = jax_xlmr.port_xlmr_state_dict(hf.state_dict(), cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 250, size=(3, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.asarray([12, 8, 3])[:, None]).astype(
        np.int32)
    ids = np.where(mask > 0, ids, 1)
    with torch.no_grad():
        hf_out = hf(input_ids=torch.tensor(ids, dtype=torch.long),
                    attention_mask=torch.tensor(mask, dtype=torch.long)
                    ).last_hidden_state.numpy()
    return hf, cfg, params, ids, mask, hf_out


def _port(state, dtype=torch.float32):
    model = xlmr.XlmRobertaEncoder(xlmr.XlmRobertaConfig.tiny(dtype=dtype))
    model.load_state_dict(state)
    return model.eval()


def _run(model, ids, mask):
    with torch.no_grad():
        return model(torch.tensor(ids).long(),
                     torch.tensor(mask).long()).float().numpy()


def _jax(cfg, params, ids, mask, method=None):
    model = jax_xlmr.XlmRobertaEncoder(cfg)
    kw = {"method": model.encode_cls} if method else {}
    return np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(mask), **kw).astype(jnp.float32))


@pytest.mark.parametrize("route", ["hf_state_dict", "from_jax"])
def test_xlmr_matches_jax_and_hf_in_f32(xlmr_pair, route):
    hf, cfg, params, ids, mask, hf_out = xlmr_pair
    state = (xlmr.port_xlmr_state_dict(hf.state_dict(),
                                       xlmr.XlmRobertaConfig.tiny())
             if route == "hf_state_dict" else xlmr.xlmr_state_from_jax(
                 jax.tree_util.tree_map(np.asarray, params)))
    got = _run(_port(state), ids, mask)
    want = _jax(cfg, params, ids, mask)
    # every position, padded ones included (they attend to valid keys)
    assert np.abs(got - want).max() < F32_ATOL
    assert np.abs(got - hf_out).max() < F32_ATOL


def test_hf_prefix_pooler_and_buffers_are_dropped(xlmr_pair):
    hf = xlmr_pair[0]
    state = {"roberta." + k: v for k, v in hf.state_dict().items()}
    state["roberta.embeddings.position_ids"] = torch.arange(66)[None]
    state["roberta.pooler.dense.weight"] = torch.zeros(32, 32)
    state["lm_head.bias"] = torch.zeros(256)
    ported = xlmr.port_xlmr_state_dict(state, xlmr.XlmRobertaConfig.tiny())
    assert ported.keys() == _port(ported).state_dict().keys()
    assert all(v.dtype == torch.float32 for v in ported.values())


def test_xlmr_bf16_follows_jax_bf16(xlmr_pair):
    hf, cfg, params, ids, mask, hf_out = xlmr_pair
    state = xlmr.port_xlmr_state_dict(hf.state_dict(),
                                      xlmr.XlmRobertaConfig.tiny())
    got = _run(_port(state, torch.bfloat16), ids, mask)
    want = _jax(jax_xlmr.XlmRobertaConfig.tiny(dtype=jnp.bfloat16), params,
                ids, mask)
    f32 = _run(_port(state), ids, mask)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_RTOL * scale
    # and bf16 is bf16: both are further from f32 than from each other
    assert np.abs(want - f32).max() > 2 * np.abs(got - want).max()


def test_encode_cls_normalized_and_matches_jax(xlmr_pair):
    hf, cfg, params, ids, mask, _ = xlmr_pair
    state = xlmr.port_xlmr_state_dict(hf.state_dict(),
                                      xlmr.XlmRobertaConfig.tiny())
    with torch.no_grad():
        emb = _port(state).encode_cls(torch.tensor(ids).long(),
                                      torch.tensor(mask).long()).numpy()
    assert emb.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(emb, _jax(cfg, params, ids, mask, True),
                               rtol=0, atol=F32_ATOL)


class SpacedTokenizer:
    """Char-code tokenizer compatible with the HF call signature."""

    def __call__(self, texts, padding, truncation, max_length, return_tensors):
        ids = np.full((len(texts), max_length), 1, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [ord(c) % 250 + 2 for c in t][: max_length]
            ids[i, : len(codes)] = codes
            mask[i, : len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _teachers(xlmr_pair, batch_size=4):
    hf, cfg, params = xlmr_pair[:3]
    ref = jax_teachers.BGEM3Teacher(jax_xlmr.XlmRobertaEncoder(cfg), params,
                                    SpacedTokenizer(), max_length=16,
                                    batch_size=batch_size)
    port = teachers.BGEM3Teacher(
        _port(xlmr.port_xlmr_state_dict(hf.state_dict(),
                                        xlmr.XlmRobertaConfig.tiny())),
        SpacedTokenizer(), max_length=16, batch_size=batch_size,
        device="cpu")
    return ref, port


def test_teacher_scoring_api_matches_jax(xlmr_pair):
    ref, port = _teachers(xlmr_pair)
    queries, docs = ["ab", "cd", "ef"], ["ab x", "cd y", "zz q"]
    negs = ["qq", "rr", "ss"]
    pair = port.score_pairs(queries, docs)
    assert pair.shape == (3,)
    mat = port.score_matrix(queries, docs)
    assert mat.shape == (3, 3)
    np.testing.assert_allclose(np.diag(mat), pair, rtol=1e-3, atol=1e-3)
    assert port.score_pairs(["ab"], ["ab"])[0] == pytest.approx(1.0, abs=1e-3)
    soft = port.soft_labels(queries, docs, negs)
    assert soft.shape == (3, 2)
    np.testing.assert_allclose(soft.sum(axis=1), 1.0, rtol=1e-5)
    inb = port.in_batch_soft_labels(queries, docs, temperature=0.5)
    np.testing.assert_allclose(inb.sum(axis=1), 1.0, rtol=1e-5)
    for got, want in ((pair, ref.score_pairs(queries, docs)),
                      (mat, ref.score_matrix(queries, docs)),
                      (soft, ref.soft_labels(queries, docs, negs)),
                      (inb, ref.in_batch_soft_labels(queries, docs, 0.5))):
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_teacher_encode_batches_and_empty(xlmr_pair):
    """Five texts in batches of 2 (a short last batch) equal one batch;
    nothing in, an empty matrix out, as in JAX."""
    ref, port = _teachers(xlmr_pair, batch_size=2)
    texts = ["가나", "다라마", "ab", "", "문서 검색"]
    whole = _teachers(xlmr_pair, batch_size=8)[1].encode(texts)
    np.testing.assert_allclose(port.encode(texts), whole, rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(whole, ref.encode(texts), rtol=0,
                               atol=F32_ATOL)
    assert port.encode([]).shape == ref.encode([]).shape == (0, 1)


@pytest.mark.parametrize("T, w", [(2.0, 0.5), (1.0, 0.0), (0.5, 2.0)])
def test_kd_loss_matches_jax(rng, T, w):
    s = rng.normal(size=(4, 4)).astype(np.float32)
    t = rng.normal(size=(4, 4)).astype(np.float32)

    def lsm(x):
        x = x - x.max(axis=-1, keepdims=True)
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

    t_logp, s_logp = lsm(t / T), lsm(s / T)
    golden = (T * T * (np.exp(t_logp) * (t_logp - s_logp)).sum(-1).mean()
              + w * ((s - t) ** 2).mean())
    got = teachers.kd_loss_with_teacher(s, t, T, w)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(float(golden), rel=1e-4)
    want = float(jax_teachers.kd_loss_with_teacher(s, t, T, w))
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    assert float(teachers.kd_loss_with_teacher(
        torch.from_numpy(t), t, T, w)) == pytest.approx(0.0, abs=1e-6)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """The same random XLM-R saved by HF as a .bin-only dir and as a
    safetensors dir."""
    hf = _hf_model(max_positions=40)
    root = tmp_path_factory.mktemp("xlmr_dirs")
    out = {}
    for name, safe in (("bin", False), ("safetensors", True)):
        hf.save_pretrained(str(root / name), safe_serialization=safe)
        out[name] = root / name
    assert list(out["bin"].glob("pytorch_model*.bin"))
    assert not list(out["bin"].glob("*.safetensors"))
    assert list(out["safetensors"].glob("*.safetensors"))
    return out


def test_from_hf_dir_reads_bin_and_safetensors_alike(hf_dirs):
    texts = ["ab cd", "가나다 라", "x"]
    embs, states = {}, {}
    for name, d in hf_dirs.items():
        t = teachers.BGEM3Teacher.from_hf_dir(
            str(d), tokenizer=SpacedTokenizer(), device="cpu", max_length=12,
            batch_size=2)
        assert t.model.config.dtype == torch.bfloat16
        assert t.model.config.max_position_embeddings == 40
        assert t.device.type == "cpu"
        states[name] = t.model.state_dict()
        embs[name] = t.encode(texts)
    for k, v in states["bin"].items():
        assert torch.equal(v, states["safetensors"][k]), k
    np.testing.assert_array_equal(embs["bin"], embs["safetensors"])
    # bf16, as JAX's from_hf_dir: within bf16 noise of JAX's embeddings
    ref = jax_teachers.BGEM3Teacher.from_hf_dir(
        str(hf_dirs["safetensors"]), tokenizer=SpacedTokenizer(),
        max_length=12, batch_size=2)
    want = ref.encode(texts)
    cos = np.sum(embs["bin"] * want, axis=1)
    assert cos.min() > 1 - 1e-3, cos


def test_from_hf_dir_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no weight files"):
        teachers.BGEM3Teacher.from_hf_dir(str(tmp_path), device="cpu",
                                          tokenizer=SpacedTokenizer())


def test_teacher_needs_a_device_without_a_card(monkeypatch, xlmr_pair):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teachers.BGEM3Teacher(_port(xlmr.port_xlmr_state_dict(
            xlmr_pair[0].state_dict(), xlmr.XlmRobertaConfig.tiny())),
            SpacedTokenizer())
