"""The V33 training loss (port of splade_tpu.losses)."""
