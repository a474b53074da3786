"""Data parallelism of the port (counterpart of dcl_net_tpu/parallel)."""

from dcl_net_tpu_torch.parallel.mesh import (  # noqa: F401
    Group,
    all_reduce_sum,
    all_reduce_sum_grad,
    allgather_host,
    batch_group,
    init_distributed,
    make_parallel_train_step,
    replicate,
    replicated,
    shard_batch,
    sharded,
)
