"""Data parallelism for the port (``parallel/mesh.py``), the counterpart of
``controlnet_tpu/parallel/``: one process per card under ``torchrun``."""

from controlnet_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean, all_reduce_sum, barrier,
                                                gather_rows, is_writer, make_mesh, replicate,
                                                shard_batch, shard_host_local_batch)

__all__ = ["Mesh", "all_reduce_mean", "all_reduce_sum", "barrier", "gather_rows", "is_writer",
           "make_mesh", "replicate", "shard_batch", "shard_host_local_batch"]
