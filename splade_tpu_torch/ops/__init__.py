"""Pooling, index and rescore ops with their Hopper kernels (port of splade_tpu.ops)."""
