"""Benchmark-side encoders (port of splade_tpu.benchmark.encoders)."""
