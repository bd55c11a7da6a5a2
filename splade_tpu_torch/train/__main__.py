"""``python -m splade_tpu_torch.train v33 ...`` dispatcher (port of
``splade_tpu/train/__main__.py``; MLM pretraining is ROADMAP.md §1)."""

import sys


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m splade_tpu_torch.train v33 [trainer args]\n"
              "subcommands:\n  v33   train the V33 SPLADE recipe")
        return 0 if len(sys.argv) >= 2 else 1
    sub, rest = sys.argv[1], sys.argv[2:]
    if sub == "v33":
        from splade_tpu_torch.train.cli import main as train_main

        return train_main(rest)
    print(f"unknown subcommand: {sub} (mlm is not ported yet: ROADMAP.md §1)")
    return 1


if __name__ == "__main__":
    sys.exit(main())
