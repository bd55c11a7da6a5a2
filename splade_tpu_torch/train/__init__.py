"""V33 training on the GPU (port of splade_tpu.train): optimizer and state,
the train step, the Trainer, checkpoints, mid-training eval and the CLI."""
