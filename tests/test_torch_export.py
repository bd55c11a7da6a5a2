"""The port's HF export (splade_tpu_torch.export, models/hf_port.py's
export_to_hf_state_dict and port_hf_state_dict) against splade_tpu's.

Counterparts of tests/test_mining_export.py::test_hf_export_roundtrip and
::test_export_public_fn_non_default_architecture: one JAX checkpoint
(``model.msgpack``) goes through the JAX exporter and the port's, which
must write the same tensor names, shapes, dtypes and values (bitwise) and
the same config.json, at depths with and without tail layers. The port's
file loads in the JAX ``load_hf_checkpoint`` and the port's, and both
encode as the JAX encoder does (f32, within 1e-5). The port's own
``model.pt`` dirs export and reload bitwise, and the CLI runs."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from safetensors.numpy import load_file as st_load

import splade_tpu.utils.tokenizer as jax_tokmod
from splade_tpu.export.hf_export import export_checkpoint_to_hf as jax_export
from splade_tpu.models import hf_port as J
from splade_tpu.models.modernbert import ModernBertConfig as JaxConfig
from splade_tpu.models.splade import SpladeEncoder as JaxSplade
from splade_tpu_torch.export import export_checkpoint_to_hf
from splade_tpu_torch.models import hf_port as P
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.models.splade import SpladeEncoder
from splade_tpu_torch.utils import safetensors_io


class Tok:
    pad_token_id = 511
    all_special_ids = [0, 1]

    def __len__(self):
        return 512

    def save_pretrained(self, d):
        with open(f"{d}/tokenizer_config.json", "w") as f:
            json.dump({"stand_in": True}, f)


def jax_checkpoint(tmp_path, layers: int, seed: int = 0):
    # the export derives the widths from the weights and writes the
    # architecture's window (128): the model is built with that window
    cfg = JaxConfig.tiny(num_hidden_layers=layers, local_attention=128)
    model = JaxSplade(cfg, pool_impl="streamed")
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), ids,
                        jnp.ones_like(ids))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    ckpt = tmp_path / f"ckpt{layers}"
    ckpt.mkdir()
    (ckpt / "model.msgpack").write_bytes(serialization.to_bytes(params))
    return model, params, ckpt


def both_exports(tmp_path, ckpt, monkeypatch, heads=4):
    monkeypatch.setattr(jax_tokmod, "create_tokenizer", lambda *a, **k: Tok())
    j_out = jax_export(str(ckpt), str(tmp_path / f"{ckpt.name}_jax"),
                       num_attention_heads=heads)
    t_out = export_checkpoint_to_hf(str(ckpt), str(tmp_path /
                                                   f"{ckpt.name}_port"),
                                    num_attention_heads=heads,
                                    tokenizer=Tok())
    return j_out, t_out


@pytest.mark.parametrize("layers", [4, 5, 6, 7])
def test_both_exporters_write_the_same_files(tmp_path, monkeypatch, layers):
    """Layers 4 and 7 are layer 0 plus whole [local, local, global]
    groups; 5 and 6 keep one and two tail layers."""
    _, _, ckpt = jax_checkpoint(tmp_path, layers)
    j_out, t_out = both_exports(tmp_path, ckpt, monkeypatch)
    want = st_load(f"{j_out}/model.safetensors")
    got = st_load(f"{t_out}/model.safetensors")
    assert list(got) == list(want)  # the same names, in the file's order
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    assert "decoder.weight" not in got and "decoder.bias" in got
    assert {f"model.layers.{layers - 1}.attn.Wqkv.weight"} <= set(got)
    j_cfg = json.loads(open(f"{j_out}/config.json").read())
    assert json.loads(open(f"{t_out}/config.json").read()) == j_cfg
    assert j_cfg["num_hidden_layers"] == layers
    assert (j_cfg["hidden_size"], j_cfg["intermediate_size"],
            j_cfg["vocab_size"]) == (64, 96, 512)
    assert safetensors_io.load_file_with_metadata(
        f"{t_out}/model.safetensors")[1] == {"format": "pt"}
    assert json.loads(open(f"{t_out}/tokenizer_config.json").read())


def test_export_roundtrip_encodes_as_the_jax_encoder(tmp_path, monkeypatch):
    """The port's export of a JAX checkpoint loads in both packages'
    load_hf_checkpoint, and every model encodes as the JAX encoder (f32,
    1e-5); the port's reload holds the exported tensors bitwise."""
    model, params, ckpt = jax_checkpoint(tmp_path, 5, seed=7)
    _, t_out = both_exports(tmp_path, ckpt, monkeypatch)
    ids = np.random.default_rng(0).integers(2, 500, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    want, _ = model.apply({"params": params}, jnp.asarray(ids),
                          jnp.asarray(mask))
    # the JAX loader reads the port's file
    cfg2, params2 = J.load_hf_checkpoint(t_out)
    assert cfg2.num_hidden_layers == 5
    r2, _ = JaxSplade(cfg2, pool_impl="streamed").apply(
        {"params": {"mlm": params2}}, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(r2), np.asarray(want), atol=1e-5)
    # the port's loader, bitwise the file, encodes as JAX
    cfg, state = P.load_hf_checkpoint(t_out)
    saved = safetensors_io.load_file(f"{t_out}/model.safetensors")
    for k, v in saved.items():
        assert torch.equal(state[k], v), k
    assert state["decoder.weight"] is state[
        "model.embeddings.tok_embeddings.weight"]
    tmodel = SpladeEncoder(cfg, pool_impl="streamed", device="cpu")
    tmodel.mlm.load_state_dict(state)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long())[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_state_dict_functions_match_the_references():
    """export_to_hf_state_dict of the port's state = JAX's of the tree;
    port_hf_state_dict of that HF state = params_from_jax of JAX's
    port_hf_state_dict, bitwise."""
    cfg = JaxConfig.tiny(num_hidden_layers=6)
    jparams = JaxSplade(cfg, pool_impl="streamed").init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))["params"]
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = ModernBertConfig.tiny(num_hidden_layers=6)
    want = J.export_to_hf_state_dict(jparams["mlm"], cfg)
    for state in (P.params_from_jax(jparams),
                  {f"mlm.{k}": v for k, v in
                   P.params_from_jax(jparams).items()}):
        got = P.export_to_hf_state_dict(state, tcfg)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    ported = P.port_hf_state_dict(want, tcfg)
    ref = P.params_from_jax(J.port_hf_state_dict(want, cfg))
    assert sorted(ported) == sorted(ref)
    for k in ref:
        assert torch.equal(ported[k], ref[k]), k
    # an HF state of a bare backbone (no model. prefix) loads too
    bare = {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in want.items()}
    assert sorted(P.port_hf_state_dict(bare, tcfg)) == sorted(ref)
    with pytest.raises(KeyError):
        P.port_hf_state_dict(
            {k: v for k, v in want.items()
             if not k.startswith("model.layers.5.")}, tcfg)


def test_the_ports_model_pt_dirs_export_bitwise(tmp_path):
    """A SpladeEncoder's state under mlm. (the MLM pre-trainer's
    final_model) and a bare ModernBertForMaskedLM's: export, reload,
    bitwise the saved tensors; a tail layer is kept."""
    from splade_tpu_torch.train.checkpoint import save_final_model

    cfg = ModernBertConfig.tiny(num_hidden_layers=5)
    model = SpladeEncoder(cfg, device="cpu").init_weights(1)
    for name, module, prefix in (("spl", model.mlm, "mlm."),
                                 ("bare", model.mlm, "")):
        final = save_final_model(str(tmp_path / name), module, prefix=prefix)
        out = export_checkpoint_to_hf(final, str(tmp_path / f"{name}_hf"),
                                      num_attention_heads=4, tokenizer=Tok())
        rcfg, state = P.load_hf_checkpoint(out)
        assert rcfg.num_hidden_layers == 5 and rcfg.decoder_bias
        saved = module.state_dict()
        assert sorted(state) == sorted(saved)
        for k in saved:
            assert torch.equal(state[k], saved[k]), k


def test_a_checkpoint_with_a_gap_in_its_layers_is_refused(tmp_path):
    cfg = ModernBertConfig.tiny(num_hidden_layers=4)
    state = SpladeEncoder(cfg, device="cpu").init_weights(0).mlm.state_dict()
    state = {k: v for k, v in state.items()
             if not k.startswith("model.layers.2.")}
    (tmp_path / "ckpt").mkdir()
    torch.save(state, tmp_path / "ckpt" / "model.pt")
    with pytest.raises(ValueError, match="0..L-1"):
        export_checkpoint_to_hf(str(tmp_path / "ckpt"), str(tmp_path / "hf"),
                                tokenizer=Tok())


def test_the_cli_exports_with_the_tokenizer_it_resolves(tmp_path,
                                                        monkeypatch):
    from splade_tpu_torch.export.__main__ import main
    from splade_tpu_torch.utils import tokenizer as tokmod

    asked = []
    monkeypatch.setattr(tokmod, "create_tokenizer",
                        lambda path=None: asked.append(path) or Tok())
    _, _, ckpt = jax_checkpoint(tmp_path, 4)
    assert main(["--checkpoint", str(ckpt), "--output",
                 str(tmp_path / "hf"), "--tokenizer", "tok-dir",
                 "--num-attention-heads", "4"]) == 0
    assert asked == ["tok-dir"]
    cfg = json.loads((tmp_path / "hf" / "config.json").read_text())
    assert (cfg["num_attention_heads"], cfg["pad_token_id"]) == (4, 511)
