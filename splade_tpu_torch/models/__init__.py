"""ModernBERT encoder, SPLADE head and weight crossing (port of splade_tpu.models)."""
