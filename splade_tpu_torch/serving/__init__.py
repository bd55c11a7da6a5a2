"""Serving tier: fused encode→search engine, dynamic batcher, HTTP server
(port of splade_tpu.serving)."""

from splade_tpu_torch.serving.batcher import DynamicBatcher
from splade_tpu_torch.serving.engine import ServingEngine

__all__ = ["DynamicBatcher", "ServingEngine"]
