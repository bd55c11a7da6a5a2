"""Data-parallel training over ``torch.distributed`` (port of
``splade_tpu/parallel``)."""

from splade_tpu_torch.parallel.mesh import (DataMesh, GradReducer,
                                            agree_any, all_gather_rows,
                                            all_reduce_mean, all_reduce_sum,
                                            barrier, broadcast_params_,
                                            init_distributed, same_on_all_ranks)

__all__ = ["DataMesh", "GradReducer", "agree_any", "all_gather_rows",
           "all_reduce_mean", "all_reduce_sum", "barrier",
           "broadcast_params_", "init_distributed", "same_on_all_ranks"]
