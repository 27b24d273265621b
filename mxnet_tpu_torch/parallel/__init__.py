"""Parallel helpers and models (counterpart of mxnet_tpu/parallel): the
device mesh and its partition rules (``mesh``, ``sharding``), the
collectives over a process group's ranks and ``shard_map``
(``collectives``), the gradient buckets and their reductions
(``overlap``), the sharded training step on one device or data-parallel
across processes (``train.ShardedTrainStep``, the path of ``bench.py``'s
ResNet-50 training number), the transformer LM's single-device training
step (``transformer``), and the single-process part of elastic training
(``elastic``: ``CheckpointManager``, ``shard_for_rank``,
``ReshardRequired``). One device per process: a mesh over several devices
spans the ranks of a ``torch.distributed`` group
(``initialize_distributed``)."""
from . import overlap  # noqa: F401
from .overlap import (bucket_plan, default_bucket_bytes,  # noqa: F401
                      tag_gradient_buckets, bucketed_reduce)
from .ring_attention import blockwise_attention  # noqa: F401
from . import elastic  # noqa: F401
from .elastic import (CheckpointManager, ReshardRequired,  # noqa: F401
                      shard_for_rank)
from . import transformer  # noqa: F401
from .mesh import (PartitionSpec, NamedSharding, DeviceMesh,  # noqa: F401
                   create_mesh, current_mesh, default_mesh_axes, mesh_scope,
                   surviving_devices, shrink_mesh)
from .collectives import (shard_map, all_reduce,  # noqa: F401
                          all_gather, reduce_scatter, all_to_all, ppermute,
                          ring_exchange, host_allreduce, host_barrier,
                          num_hosts, host_rank, initialize_distributed)
from .sharding import (PartitionRules, ShardingStrategy,  # noqa: F401
                       data_parallel, fsdp, tensor_parallel,
                       make_param_sharding, infer_rules_for_block,
                       host_array, relayout_params, match_partition_rules,
                       named_shardings)
from .train import (functional_call, extract_params,  # noqa: F401
                    attach_params, ShardedTrainStep)
