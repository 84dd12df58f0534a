"""The dp x hidden-channel mesh (counterpart of ``ipoke_tpu/parallel``):
``mesh`` places batches and params, ``comm`` holds the collectives,
``dryrun`` drives a sharded step (``python -m
ipoke_tpu_torch.parallel.dryrun --n N``)."""

from .mesh import (
    Mesh,
    average_grads,
    batch_spec,
    current_mesh,
    flow_param_specs,
    gather_batch,
    gather_params,
    hybrid_batch_spec,
    make_hybrid_mesh,
    make_mesh,
    mean_over_batch,
    replicate,
    shard_batch,
    shard_batch_hybrid,
    shard_params,
)
