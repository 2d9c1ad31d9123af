"""Parallelism over ``torch.distributed``: meshes, data, FSDP, tensor,
expert and pipeline parallelism, the dp × spatial train step
(``parallel.spatial``), halo exchange (``extra.chunk_decode``) and the
multi-process dry run (``parallel.mp_dryrun``).

Port of ``diffsci_tpu/parallel/``, with the same names. One process a
card: NCCL on the card, gloo on the CPU (``parallel/mesh.py``). FSDP
gathers each layer's weights as it runs and composes with tensor
parallelism (``shard_state_fsdp(..., tensor_axis=)``, ``fsdp_specs(...,
existing_specs=)``); the spatial step takes PUNetG and PUNetGCond
(``parallel/spatial.py``).
"""

from diffsci_tpu_torch.parallel.mesh import (
    make_mesh,
    initialize_distributed,
    shard_batch,
    replicate,
    batch_sharding,
    replicated,
    pad_to_multiple,
    constrain_batch,
    gather_batch,
    DATA_AXIS,
    SPATIAL_AXIS,
    TENSOR_AXIS,
)

from diffsci_tpu_torch.parallel.tensor_parallel import (
    tensor_parallel_specs,
    shard_params_tensor_parallel,
    shard_state_tensor_parallel,
)

from diffsci_tpu_torch.parallel.fsdp import (
    fsdp_specs,
    shard_state_fsdp,
)

from diffsci_tpu_torch.parallel.expert_parallel import (
    EXPERT_AXIS,
    expert_parallel_specs,
    shard_params_expert_parallel,
    shard_state_expert_parallel,
)

from diffsci_tpu_torch.parallel.spatial import shard_state_spatial

from diffsci_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    stack_block_params,
    unstack_block_params,
    shard_stacked_params,
    pipeline_apply,
    make_dit_pipeline,
)

__all__ = [
    "make_mesh", "initialize_distributed", "shard_batch", "replicate", "batch_sharding", "replicated",
    "pad_to_multiple", "constrain_batch", "DATA_AXIS", "SPATIAL_AXIS", "TENSOR_AXIS",
    "tensor_parallel_specs", "shard_params_tensor_parallel",
    "shard_state_tensor_parallel", "fsdp_specs", "shard_state_fsdp",
    "EXPERT_AXIS", "expert_parallel_specs", "shard_params_expert_parallel",
    "shard_state_expert_parallel",
    "STAGE_AXIS", "stack_block_params", "unstack_block_params",
    "shard_stacked_params", "pipeline_apply", "make_dit_pipeline",
    "gather_batch", "shard_state_spatial",
]
