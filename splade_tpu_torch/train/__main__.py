"""``python -m splade_tpu_torch.train {v33,mlm} ...`` dispatcher (port of
``splade_tpu/train/__main__.py``)."""

import sys


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m splade_tpu_torch.train {v33,mlm} "
              "[trainer args]\n"
              "subcommands:\n  v33   train the V33 SPLADE recipe\n"
              "  mlm   Korean MLM pre-training (configs/pretrain_mlm.yaml)")
        return 0 if len(sys.argv) >= 2 else 1
    sub, rest = sys.argv[1], sys.argv[2:]
    if sub == "v33":
        from splade_tpu_torch.train.cli import main as train_main

        return train_main(rest)
    if sub == "mlm":
        from splade_tpu_torch.train.mlm import main as mlm_main

        return mlm_main(rest)
    print(f"unknown subcommand: {sub}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
