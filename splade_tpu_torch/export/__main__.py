"""``python -m splade_tpu_torch.export --checkpoint DIR --output DIR
[--tokenizer PATH] [--num-attention-heads N]``: a training checkpoint or
final-model dir (the port's ``model.pt`` or the JAX package's
``model.msgpack``) -> an HF ModernBertForMaskedLM dir (the arguments of
``scripts/export_hf.py``)."""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from splade_tpu_torch.export.hf_export import export_checkpoint_to_hf


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser("splade-tpu-torch HF export")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--num-attention-heads", type=int, default=None,
                   help="written to config.json; not recoverable from the "
                        "fused qkv weights (default: the architecture's)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    export_checkpoint_to_hf(args.checkpoint, args.output, args.tokenizer,
                            num_attention_heads=args.num_attention_heads)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
