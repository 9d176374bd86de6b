"""Parallelism over several GPUs (port of audioldm_tpu/parallel): process
groups by axis name and batch sharding (``mesh``), the tensor-parallel
UNet and its generation and (dp, tp) training steps (``tp``).

The port runs one process a GPU under ``torchrun``; data parallelism is the
batch split over the ``dp`` group with one coalesced all-reduce of the
adapter gradients a step (``train.trainer.train_step(mesh=)``,
``train.distill.distill_step(mesh=)``), or, for serving, the padded bucket
split over the ranks and gathered back (``serve.ServeEngine(mesh=)``).

What has no counterpart: ``audioldm_tpu/kernels/sharding.py`` wraps the
Pallas kernels in ``shard_map`` so that GSPMD runs them on each device's
batch rows and head group; here each CUDA kernel runs on the local batch
and the local heads of its own rank, so there is nothing to bridge. The
``NamedSharding`` helpers ``batch_sharding``, ``replicated`` and
``module_shardings`` place arrays for XLA and have no meaning for torch.
"""

from audioldm_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    gather_rows,
    init_distributed,
    local_rows,
    make_mesh,
    shard_batch,
    torchrun_hint,
    world_size,
)
from audioldm_tpu_torch.parallel.tp import (
    make_tp_generate_fn,
    make_tp_mesh,
    make_tp_mesh_2d,
    make_tp_train_step,
    make_tp_unet_step,
    reduce_tp_grads,
    shard_modules,
    shard_unet_params,
    split_blocks,
    unet_tp_specs,
)

__all__ = [
    "Mesh",
    "all_reduce_",
    "gather_rows",
    "init_distributed",
    "local_rows",
    "make_mesh",
    "make_tp_generate_fn",
    "make_tp_mesh",
    "make_tp_mesh_2d",
    "make_tp_train_step",
    "make_tp_unet_step",
    "reduce_tp_grads",
    "shard_batch",
    "shard_modules",
    "shard_unet_params",
    "split_blocks",
    "torchrun_hint",
    "unet_tp_specs",
    "world_size",
]
