"""Sharded rendering and data-parallel training (counterpart of
exavatar_release_tpu/parallel/).

- image row bands sharded over the ranks of a mesh axis, the Gaussians
  replicated or (``gaussian_shard``) sharded with an ``all_to_all`` exchange,
  through the same compositing kernels as the single-device render;
- data parallelism over frames across processes, and the two combined;
- a ``LocalMesh`` of this process's devices for the standalone renders, and a
  ``ProcessMesh`` over ``torch.distributed`` (NCCL on cards, gloo on the
  CPU) for the in-context renders and the train steps.
"""
from .dp_tile_train import dp_tile_train_step
from .dp_train import dp_train_step, replicate_to_mesh, shard_batch_to_mesh
from .mesh import init_distributed, make_host_mesh, make_mesh
from .sharded_raster import (
    rasterize_gaussian_sharded,
    rasterize_gaussian_sharded_in_context,
    rasterize_in_context,
    rasterize_sharded,
    resolve_exchange_cap,
)

__all__ = [
    "init_distributed",
    "make_host_mesh",
    "make_mesh",
    "rasterize_sharded",
    "rasterize_gaussian_sharded",
    "rasterize_in_context",
    "rasterize_gaussian_sharded_in_context",
    "resolve_exchange_cap",
    "dp_train_step",
    "dp_tile_train_step",
    "replicate_to_mesh",
    "shard_batch_to_mesh",
]
