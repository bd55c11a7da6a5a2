"""Training checkpoints into the port's serving encoder
(splade_tpu_torch.benchmark.encoders.SparseEncoderV33.from_checkpoint /
from_any and splade_tpu_torch.train.checkpoint.load_model_state).

The JAX package saves a tiny model with ``save_final_model`` (flax msgpack);
the port reads the file with its own reader (no flax) and must encode the
same texts to the JAX encoder's vectors: within 1e-4 in f32 (the weights
cross exactly; only f32 sum order differs), and within 3e-2 of each
vector's largest weight through ``from_checkpoint``, which casts the model
to bf16 (8 bits of mantissa through 2 layers). The port's own ``model.pt``
dirs (a SpladeEncoder's, and a bare MLM model's saved under ``mlm.``) load
to bitwise the saved weights."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from splade_tpu.benchmark.encoders import SparseEncoderV33 as JaxEncoder
from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu.train.checkpoint import save_final_model as jax_save_final
from splade_tpu_torch.benchmark.encoders import SparseEncoderV33
from splade_tpu_torch.models.hf_port import params_from_jax
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.train import checkpoint as ckpt

# tiny shapes: more intra-op threads only contend with the other test
# workers for the host's cores
torch.set_num_threads(1)

VOCAB = 128
LAYERS = 2


class Tok:
    """char-code tokenizer with the attributes the encoders read"""

    pad_token_id = 0
    all_special_ids = [0, 1, 2]

    def __len__(self):
        return VOCAB

    def get_vocab(self):
        return {"[PAD]": 0, "[CLS]": 1, "<s>": 2, "a": 3}

    def __call__(self, texts, padding="max_length", truncation=True,
                 max_length=16, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            codes = [ord(c) % (VOCAB - 3) + 3 for c in t][:max_length]
            ids[i, :len(codes)] = codes
            mask[i, :len(codes)] = 1
        return {"input_ids": ids, "attention_mask": mask}


TEXTS = ["검색 모델 한국어", "문서 질의", "벡터 학습 평가 검색 문서", "a"]


def _tiny(cls, **over):
    return cls.tiny(num_hidden_layers=LAYERS, vocab_size=VOCAB,
                    pad_token_id=0, **over)


@pytest.fixture(scope="module")
def jax_final(tmp_path_factory):
    """A tiny JAX SpladeEncoder with a non-trivial decoder bias, saved by
    the JAX package's save_final_model; its encoder's vectors."""
    jmodel = JaxSplade(_tiny(JaxConfig), pool_impl="streamed", pool_tile=64)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), ids0,
                                  jnp.ones_like(ids0))["params"]
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                    params)
    params["mlm"]["decoder_bias"] = np.random.default_rng(0).normal(
        0, 0.5, params["mlm"]["decoder_bias"].shape).astype(np.float32)
    out = tmp_path_factory.mktemp("jax_run")
    path = jax_save_final(str(out), params)
    enc = JaxEncoder(jmodel, params, Tok(), query_max_length=8,
                     doc_max_length=16, batch_size=4, query_top_k=0)
    return path, params, enc.encode_documents(TEXTS), enc.encode_queries(TEXTS)


def _dense(vecs):
    out = np.zeros((len(vecs), VOCAB), np.float32)
    for i, (idx, val) in enumerate(vecs):
        out[i, idx] = val
    return out


def test_msgpack_reader_gives_the_saved_tree(jax_final):
    path, params, _, _ = jax_final
    tree = ckpt.read_msgpack_params(f"{path}/model.msgpack")
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_load_model_state_from_msgpack_matches_jax_in_f32(jax_final):
    path, params, j_docs, _ = jax_final
    state = ckpt.load_model_state(path)
    direct = params_from_jax(params)
    assert state.keys() == direct.keys()
    assert all(torch.equal(state[k], direct[k]) for k in state)
    model = SpladeEncoder(_tiny(ModernBertConfig), device="cpu")
    model.mlm.load_state_dict(state)
    enc = SparseEncoderV33(model, Tok(), query_max_length=8,
                           doc_max_length=16, batch_size=4, device="cpu")
    np.testing.assert_allclose(_dense(enc.encode_documents(TEXTS)),
                               _dense(j_docs), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("loader", ["from_checkpoint", "from_any"])
def test_from_checkpoint_of_a_jax_final_model_encodes_as_jax(jax_final,
                                                             loader):
    path, _, j_docs, j_queries = jax_final
    enc = getattr(SparseEncoderV33, loader)(
        path, Tok(), device="cpu", config=_tiny(ModernBertConfig),
        query_max_length=8, doc_max_length=16, batch_size=4, query_top_k=0)
    assert enc.model.mlm.decoder.weight.dtype == torch.bfloat16
    assert enc.model.config.vocab_size == len(Tok())
    if loader == "from_any":
        assert enc.source_path == str(path)
    for got, want in ((enc.encode_documents(TEXTS), j_docs),
                      (enc.encode_queries(TEXTS), j_queries)):
        got, want = _dense(got), _dense(want)
        scale = np.abs(want).max(1, keepdims=True)
        assert np.all(np.abs(got - want) <= 3e-2 * scale), (
            np.abs(got - want) / scale).max()
        assert np.all(got[:, [0, 1, 2]] == 0)  # banned tokens


def test_msgpack_reader_reads_bfloat16_and_scalars(tmp_path):
    """bf16 leaves arrive as 16-bit words and widen exactly; numpy scalars
    and nested maps survive; nothing of flax or ml_dtypes is needed to
    read."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 7)).astype(ml_dtypes.bfloat16)
    tree = {"a": {"w": w, "n": np.arange(4, dtype=np.int32)},
            "step": np.float32(2.5), "k": 3}
    (tmp_path / "model.msgpack").write_bytes(serialization.to_bytes(tree))
    got = ckpt.read_msgpack_params(tmp_path / "model.msgpack")
    assert got["a"]["w"].dtype == np.float32
    assert np.array_equal(got["a"]["w"], w.astype(np.float32))
    assert np.array_equal(got["a"]["n"], tree["a"]["n"])
    assert got["step"] == np.float32(2.5) and got["k"] == 3


def _port_model(seed):
    return SpladeEncoder(_tiny(ModernBertConfig), device="cpu"
                         ).init_weights(seed)


@pytest.mark.parametrize("kind", ["splade_final", "mlm_final", "checkpoint",
                                  "mlm_checkpoint"])
def test_from_checkpoint_of_the_ports_own_dirs(tmp_path, kind):
    """final_model and checkpoint dirs written by the port's trainers (a
    SpladeEncoder's state, or the MLM trainer's bare model, saved under
    ``mlm.`` as its final model) load to the saved weights, bf16-rounded."""
    from splade_tpu_torch.config.v33 import V33TrainingConfig
    from splade_tpu_torch.train.state import create_train_state

    model = _port_model(3)
    if kind == "splade_final":
        path = ckpt.save_final_model(str(tmp_path), model)
    elif kind == "mlm_final":
        path = ckpt.save_final_model(str(tmp_path), model.mlm, prefix="mlm.")
    else:
        saved = model if kind == "checkpoint" else model.mlm
        state = create_train_state(saved, V33TrainingConfig(), 10)
        path = ckpt.save_checkpoint(str(tmp_path), state, epoch=1)
    enc = SparseEncoderV33.from_any(path, Tok(), device="cpu",
                                    config=_tiny(ModernBertConfig))
    want = model.mlm.state_dict()
    got = enc.model.mlm.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k].to(torch.bfloat16)), k
    assert len(enc.encode_documents(TEXTS)) == len(TEXTS)


def test_from_any_dispatches_by_the_file_it_finds(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(SparseEncoderV33, "from_checkpoint", classmethod(
        lambda cls, path, tok, **kw: calls.append(("ckpt", path)) or cls))
    monkeypatch.setattr(SparseEncoderV33, "from_hf_dir", classmethod(
        lambda cls, path, tok=None, **kw: calls.append(("hf", path)) or cls))
    for name, kind in (("model.pt", "ckpt"), ("model.msgpack", "ckpt"),
                       ("model.safetensors", "hf")):
        d = tmp_path / name.replace(".", "_")
        d.mkdir()
        (d / name).write_bytes(b"")
        SparseEncoderV33.from_any(str(d), Tok())
        assert calls[-1] == (kind, str(d))
    with pytest.raises(FileNotFoundError, match="model.pt or model.msgpack"):
        ckpt.load_model_state(str(tmp_path))
