"""Seeded weights of a ModernBERT MLM model, made by the benchmark.

The benchmark, not the program, makes the weights, so the reference gets
the same numbers without reading anything the program made: one
``torch.Generator`` on the card draws every matrix in one call (normal,
std 0.02, in the dtype the cell runs the model in), norms are 1 and the
decoder bias is 0, the scheme of the port's ``init_weights``. The names are
HuggingFace ``ModernBertForMaskedLM``'s, which the port and the reference
both use; the decoder is tied to the token embedding.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

INIT_STD = 0.02


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter: init is "normal", "ones" or
    "zeros"; the tied decoder weight is not listed (see ``make_weights``)."""
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    specs = [("model.embeddings.tok_embeddings.weight", (V, H), "normal"),
             ("model.embeddings.norm.weight", (H,), "ones")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        if i:
            specs.append((p + "attn_norm.weight", (H,), "ones"))
        specs += [(p + "attn.Wqkv.weight", (3 * H, H), "normal"),
                  (p + "attn.Wo.weight", (H, H), "normal"),
                  (p + "mlp_norm.weight", (H,), "ones"),
                  (p + "mlp.Wi.weight", (2 * I, H), "normal"),
                  (p + "mlp.Wo.weight", (H, I), "normal")]
    specs += [("model.final_norm.weight", (H,), "ones"),
              ("head.dense.weight", (H, H), "normal"),
              ("head.norm.weight", (H,), "ones"),
              ("decoder.bias", (V,), "zeros")]
    return specs


def make_weights(cfg: dict, seed: int, device, dtype=torch.float32,
                 decoder_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device`` in ``dtype``; the matrices are views of
    one buffer drawn in one call. ``decoder.weight`` is the embedding;
    ``decoder_bias`` fills the decoder's bias (a route may shift it, see
    the serving configuration)."""
    specs = param_specs(cfg)
    sizes = [torch.Size(s).numel() for _, s, init in specs if init == "normal"]
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.empty(sum(sizes), device=device, dtype=dtype)
    flat.normal_(0.0, INIT_STD, generator=g)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "normal":
            n = torch.Size(shape).numel()
            out[name] = flat[at:at + n].view(shape)
            at += n
        else:
            fill = {"ones": 1.0, "zeros": 0.0}[init]
            if name == "decoder.bias":
                fill = decoder_bias
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
    out["decoder.weight"] = out["model.embeddings.tok_embeddings.weight"]
    return out
