"""Tokenizer, text and device helpers (port of splade_tpu.utils)."""
