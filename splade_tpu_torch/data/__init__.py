"""Training data: JSONL triplets, collation and the sharded batch iterator
(port of splade_tpu.data; copies, numpy-seeded as there)."""

from splade_tpu_torch.data.collator import TripletCollator
from splade_tpu_torch.data.loader import TripletDataset, load_training_data
from splade_tpu_torch.data.pipeline import (ShardedBatchIterator,
                                            create_dataloader)

__all__ = [
    "TripletDataset", "load_training_data", "TripletCollator",
    "create_dataloader", "ShardedBatchIterator",
]
