"""Weights into and out of the port: ``splade_tpu`` parameter trees and HF
dirs.

Counterpart of ``splade_tpu/models/hf_port.py``. The port's module tree uses
HuggingFace ``ModernBertForMaskedLM`` names, so an HF state dict loads as it
is (``port_hf_state_dict``) and exports as it is plus the decoder's names
(``export_to_hf_state_dict``). ``*.safetensors`` files are read by the
port's own reader (``utils/safetensors_io.py``), never by the
``safetensors`` package. ``params_from_jax`` carries a ``splade_tpu``
``SpladeEncoder`` tree across:
that model runs the repeating [local, local, global] unit as a scan, so HF
layers 3b+1, 3b+2, 3b+3 sit STACKED on a leading axis under
``blocks/{local_a, local_b, global_c}``; layer 0 is ``layer0`` and remainder
layers are ``tail_{i}``. Flax kernels are [in, out] and are transposed to
torch's [out, in].
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.utils import safetensors_io


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _layer_into(out: Dict[str, torch.Tensor], layer: Mapping[str, Any],
                i: int) -> None:
    pre = f"model.layers.{i}."
    out[pre + "attn.Wqkv.weight"] = _t(layer["attn"]["Wqkv"]["kernel"]).T
    out[pre + "attn.Wo.weight"] = _t(layer["attn"]["Wo"]["kernel"]).T
    out[pre + "mlp_norm.weight"] = _t(layer["mlp_norm"]["scale"])
    out[pre + "mlp.Wi.weight"] = _t(layer["mlp"]["Wi"]["kernel"]).T
    out[pre + "mlp.Wo.weight"] = _t(layer["mlp"]["Wo"]["kernel"]).T
    if "attn_norm" in layer:
        out[pre + "attn_norm.weight"] = _t(layer["attn_norm"]["scale"])


def _index_tree(tree: Mapping[str, Any], b: int) -> Dict[str, Any]:
    return {k: (_index_tree(v, b) if isinstance(v, Mapping)
                else np.asarray(v)[b]) for k, v in tree.items()}


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``splade_tpu`` SpladeEncoder params ({"mlm": {...}} or the mlm tree
    itself) as nested numpy dicts -> the port's ``ModernBertForMaskedLM``
    state dict (f32, contiguous)."""
    p = params["mlm"] if "mlm" in params else params
    emb = _t(p["tok_embeddings"]["embedding"])
    out: Dict[str, torch.Tensor] = {
        "model.embeddings.tok_embeddings.weight": emb,
        "model.embeddings.norm.weight": _t(p["emb_norm"]["scale"]),
        "model.final_norm.weight": _t(p["final_norm"]["scale"]),
        "head.dense.weight": _t(p["head_dense"]["kernel"]).T,
        "head.norm.weight": _t(p["head_norm"]["scale"]),
        "decoder.weight": emb,  # tied
    }
    if "decoder_bias" in p:
        out["decoder.bias"] = _t(p["decoder_bias"])
    _layer_into(out, p["layer0"], 0)
    if "blocks" in p:
        nb = np.asarray(p["blocks"]["local_a"]["mlp_norm"]["scale"]).shape[0]
        for role, off in (("local_a", 1), ("local_b", 2), ("global_c", 3)):
            for b in range(nb):
                _layer_into(out, _index_tree(p["blocks"][role], b),
                            3 * b + off)
    for name, layer in p.items():
        if name.startswith("tail_"):
            _layer_into(out, layer, int(name[len("tail_"):]))
    return {k: v.contiguous() for k, v in out.items()}


def strip_wrapper_prefix(state: Dict[str, Any]) -> Dict[str, Any]:
    """Add the backbone's ``model.`` prefix where a wrapper stripped it
    (e.g. a SPLADE wrapper saving the bare backbone)."""
    if any(k.startswith("model.") for k in state):
        return state
    return {k if k.startswith(("head.", "decoder.")) else f"model.{k}": v
            for k, v in state.items()}


def _layer_names(i: int, attn_norm: bool) -> Tuple[str, ...]:
    pre = f"model.layers.{i}."
    names = ("attn.Wqkv.weight", "attn.Wo.weight", "mlp_norm.weight",
             "mlp.Wi.weight", "mlp.Wo.weight")
    return tuple(pre + n for n in names + (("attn_norm.weight",)
                                           if attn_norm else ()))


def hf_names(config: ModernBertConfig) -> Tuple[str, ...]:
    """The ``ModernBertForMaskedLM`` weights that ``config`` names, in the
    order the reference's export writes them: embeddings, norms, head, the
    decoder, layer 0 (no attention norm), the [local, local, global]
    groups role by role (every group's first local layer, then their
    second, then their global one), then the tail layers."""
    names = ["model.embeddings.tok_embeddings.weight",
             "model.embeddings.norm.weight", "model.final_norm.weight",
             "head.dense.weight", "head.norm.weight", "decoder.weight"]
    if config.decoder_bias:
        names.append("decoder.bias")
    names.extend(_layer_names(0, attn_norm=False))
    L = config.num_hidden_layers
    nb = (L - 1) // 3
    layers = ([3 * b + off for off in (1, 2, 3) for b in range(nb)]
              + list(range(1 + 3 * nb, L)))
    for i in layers:
        names.extend(_layer_names(i, attn_norm=True))
    return tuple(names)


def _as_f32(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.detach().to("cpu", torch.float32).contiguous()


def port_hf_state_dict(state: Mapping[str, Any], config: ModernBertConfig
                       ) -> Dict[str, torch.Tensor]:
    """HF ``ModernBertForMaskedLM`` state dict (torch tensors or numpy
    arrays, with or without the backbone's ``model.`` prefix) -> the port's
    state dict: the weights ``config`` names, f32 on the CPU. The decoder
    weight is tied to the embedding, so an HF file's ``decoder.weight``
    (usually left out) is not read. A weight the config names and the state
    lacks raises KeyError."""
    state = strip_wrapper_prefix(dict(state))
    out = {k: _as_f32(state[k]) for k in hf_names(config)
           if k != "decoder.weight"}
    out["decoder.weight"] = out["model.embeddings.tok_embeddings.weight"]
    return out


def export_to_hf_state_dict(state: Mapping[str, Any],
                            config: ModernBertConfig) -> Dict[str, np.ndarray]:
    """The port's model state (``ModernBertForMaskedLM`` names, or a
    ``SpladeEncoder``'s under ``mlm.``, or a bare backbone's) -> the HF
    ``ModernBertForMaskedLM`` state dict the reference's export writes:
    numpy float32, ``model.``-prefixed backbone names, ``decoder.weight``
    tied to the embedding and ``decoder.bias`` when the config has one."""
    if state and all(k.startswith("mlm.") for k in state):
        state = {k[len("mlm."):]: v for k, v in state.items()}
    state = strip_wrapper_prefix(dict(state))
    out: Dict[str, np.ndarray] = {}
    for k in hf_names(config):
        src = ("model.embeddings.tok_embeddings.weight"
               if k == "decoder.weight" else k)
        out[k] = _as_f32(state[src]).numpy()
    return out


def read_hf_state(model_dir: str) -> Dict[str, Any]:
    """Every weight file of an HF-format dir as one state dict:
    ``*.safetensors`` when there are any (through the port's own reader),
    else ``pytorch_model*.bin`` and ``model*.pt``."""
    d = Path(model_dir)
    state: Dict[str, Any] = {}
    st_files = sorted(d.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            state.update(safetensors_io.load_file(f))
    else:
        for f in sorted(d.glob("pytorch_model*.bin")) + sorted(d.glob("model*.pt")):
            state.update(torch.load(str(f), map_location="cpu",
                                    weights_only=True))
    if not state:
        raise FileNotFoundError(f"no weight files under {model_dir}")
    return state


def load_hf_checkpoint(model_dir: str,
                       config: Optional[ModernBertConfig] = None,
                       **config_over: Any
                       ) -> Tuple[ModernBertConfig, Dict[str, torch.Tensor]]:
    """HF ModernBERT dir (config.json + ``*.safetensors`` or
    ``pytorch_model*.bin``) -> (config, state dict in the port's names,
    f32)."""
    d = Path(model_dir)
    if config is None:
        hf_cfg = json.loads((d / "config.json").read_text())
        config = ModernBertConfig.from_hf_dict(hf_cfg, **config_over)
    return config, port_hf_state_dict(read_hf_state(model_dir), config)
