"""Data-parallel training over ``torch.distributed`` and the device mesh
of the doc-sharded indexes (port of ``splade_tpu/parallel``)."""

from splade_tpu_torch.parallel.mesh import (DataMesh, DeviceMesh, GradReducer,
                                            agree_any, all_gather_rows,
                                            all_reduce_mean, all_reduce_sum,
                                            barrier, broadcast_params_,
                                            init_distributed, make_mesh,
                                            same_on_all_ranks)

__all__ = ["DataMesh", "DeviceMesh", "GradReducer", "agree_any",
           "all_gather_rows", "all_reduce_mean", "all_reduce_sum", "barrier",
           "broadcast_params_", "init_distributed", "make_mesh",
           "same_on_all_ranks"]
