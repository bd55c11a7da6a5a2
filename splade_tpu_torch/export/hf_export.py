"""Export a trained checkpoint to HuggingFace ModernBertForMaskedLM format.

Counterpart of ``splade_tpu/export/hf_export.py``: load the training
checkpoint, save the inner MLM model as ``model.safetensors`` (the port's
own writer, ``utils/safetensors_io.py``) + ``config.json`` + tokenizer
files, so the OpenSearch ecosystem path (client-side encoding from an HF
dir) keeps working. It reads the port's ``model.pt`` dirs and the JAX
package's ``model.msgpack`` dirs; the files it writes are the ones the
reference's export writes for the same weights.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

from splade_tpu_torch.models.hf_port import (export_to_hf_state_dict,
                                             params_from_jax)
from splade_tpu_torch.models.modernbert import ModernBertConfig
from splade_tpu_torch.train.checkpoint import (MODEL_FILE, MSGPACK_FILE,
                                               load_model_state,
                                               read_msgpack_params)
from splade_tpu_torch.utils import safetensors_io

logger = logging.getLogger(__name__)

_LAYER = re.compile(r"^model\.layers\.(\d+)\.")


def _hf_config_dict(config) -> dict:
    return {
        "architectures": ["ModernBertForMaskedLM"],
        "model_type": "modernbert",
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_hidden_layers,
        "num_attention_heads": config.num_attention_heads,
        "global_attn_every_n_layers": config.global_attn_every_n_layers,
        "local_attention": config.local_attention,
        "global_rope_theta": config.global_rope_theta,
        "local_rope_theta": config.local_rope_theta,
        "norm_eps": config.norm_eps,
        "layer_norm_eps": config.norm_eps,
        "norm_bias": False,
        "attention_bias": False,
        "mlp_bias": False,
        "classifier_bias": False,
        "decoder_bias": config.decoder_bias,
        "hidden_activation": "gelu",
        "classifier_activation": "gelu",
        "max_position_embeddings": config.max_position_embeddings,
        "pad_token_id": config.pad_token_id,
        "position_embedding_type": "absolute",
        "sparse_prediction": False,
        "dtype": "float32",
    }


def _layer_groups_of_tree(tree: Mapping[str, Any]) -> Tuple[int, int]:
    """(scan groups, tail layers) of a ``splade_tpu`` parameter tree:
    ``blocks`` stacks the [local, local, global] groups on a leading axis;
    a depth not of the form 1+3k keeps its extra layers as ``tail_{i}``."""
    mlm = tree["mlm"] if "mlm" in tree else tree

    def first_leaf(node):
        return (first_leaf(next(iter(node.values())))
                if isinstance(node, Mapping) else node)

    n_groups = (int(first_leaf(mlm["blocks"]).shape[0])
                if "blocks" in mlm else 0)
    return n_groups, sum(1 for k in mlm if k.startswith("tail_"))


def _layer_groups_of_state(state: Mapping[str, Any]) -> Tuple[int, int]:
    """(groups, tail layers) of a state dict in HF names: layer 0, then
    whole [local, local, global] groups, then the rest. Its layers must be
    numbered 0..L-1 without a gap."""
    layers = sorted({int(m.group(1)) for k in state
                     for m in [_LAYER.match(k)] if m})
    if layers != list(range(len(layers))) or not layers:
        raise ValueError(f"the checkpoint's layers {layers} are not "
                         "numbered 0..L-1")
    return (len(layers) - 1) // 3, (len(layers) - 1) % 3


def read_checkpoint(ckpt_dir: str) -> Tuple[Dict[str, Any], int, int]:
    """The weights of a ``model.pt`` or ``model.msgpack`` dir in HF names,
    with its (groups, tail layers). For a msgpack tree they are counted
    from its ``blocks`` and ``tail_*`` entries, as the reference counts
    them, and must agree with the layers the tree holds."""
    d = Path(ckpt_dir)
    if not (d / MODEL_FILE).exists() and (d / MSGPACK_FILE).exists():
        tree = read_msgpack_params(d / MSGPACK_FILE)
        groups, tails = _layer_groups_of_tree(tree)
        state = params_from_jax(tree)
        if _layer_groups_of_state(state) != (groups, tails):
            raise ValueError(f"{ckpt_dir}: {groups} groups and {tails} tail "
                             "layers do not number its layers 0..L-1")
        return state, groups, tails
    state = load_model_state(ckpt_dir)
    return (state, *_layer_groups_of_state(state))


def export_checkpoint_to_hf(
    ckpt_dir: str,
    output_dir: str,
    tokenizer_path: Optional[str] = None,
    num_attention_heads: Optional[int] = None,
    tokenizer=None,
) -> str:
    """Checkpoint dir -> HF dir (config.json, model.safetensors, tokenizer
    files). ``tokenizer`` takes a tokenizer object in place of loading one
    from ``tokenizer_path`` (a stand-in, where transformers is missing); it
    must have ``pad_token_id``, ``__len__`` and ``save_pretrained``."""
    if tokenizer is None:
        from splade_tpu_torch.utils.tokenizer import create_tokenizer

        tokenizer = create_tokenizer(tokenizer_path)
    # the architecture comes from the weights: a template from the default
    # config would reject any other checkpoint, and counting only the scan
    # groups would export a shallower network than a depth not of the form
    # 1+3k trained
    state, n_groups, n_tail = read_checkpoint(ckpt_dir)
    emb = state["model.embeddings.tok_embeddings.weight"]
    config = ModernBertConfig(
        vocab_size=emb.shape[0],
        hidden_size=emb.shape[1],
        num_hidden_layers=1 + 3 * n_groups + n_tail,
        # torch stores Wi [2 * intermediate, hidden] (GeGLU)
        intermediate_size=state["model.layers.0.mlp.Wi.weight"].shape[0] // 2,
        # heads are not recoverable from fused qkv weights: metadata only
        **({"num_attention_heads": num_attention_heads}
           if num_attention_heads else {}),
        pad_token_id=tokenizer.pad_token_id,
        decoder_bias="decoder.bias" in state,
    )
    if config.vocab_size != len(tokenizer):
        logger.warning("checkpoint vocab %d != tokenizer vocab %d",
                       config.vocab_size, len(tokenizer))
    hf_state = export_to_hf_state_dict(state, config)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    # the decoder is tied to the embedding: persist the convention HF uses
    # (the tied copy left out)
    hf_state.pop("decoder.weight", None)
    safetensors_io.save_file(hf_state, out / "model.safetensors",
                             metadata={"format": "pt"})
    (out / "config.json").write_text(json.dumps(_hf_config_dict(config),
                                                indent=2))
    tokenizer.save_pretrained(str(out))
    logger.info("exported %s (%d layers: layer 0, %d groups, %d tail) -> %s",
                ckpt_dir, config.num_hidden_layers, n_groups, n_tail, out)
    return str(out)
