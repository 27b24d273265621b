"""Parallel helpers and models (counterpart of mxnet_tpu/parallel), on one
device so far: the device mesh and its partition rules (``mesh``,
``sharding``: any mesh shape for the specs, one device to train on), the
sharded training step (``train.ShardedTrainStep``, the path of
``bench.py``'s ResNet-50 training number), the bucket plan that the packed
optimizer apply shares with the gradient reduction of the multi-GPU slice
(``overlap``), the transformer LM's single-device training step
(``transformer``), and the single-process part of elastic training
(``elastic``: ``CheckpointManager``, ``shard_for_rank``,
``ReshardRequired``)."""
from . import overlap  # noqa: F401
from . import elastic  # noqa: F401
from .elastic import (CheckpointManager, ReshardRequired,  # noqa: F401
                      shard_for_rank)
from . import transformer  # noqa: F401
from .mesh import (PartitionSpec, NamedSharding, DeviceMesh,  # noqa: F401
                   create_mesh, current_mesh, default_mesh_axes, mesh_scope,
                   surviving_devices, shrink_mesh)
from .sharding import (PartitionRules, ShardingStrategy,  # noqa: F401
                       data_parallel, fsdp, tensor_parallel,
                       make_param_sharding, infer_rules_for_block,
                       host_array, relayout_params, match_partition_rules,
                       named_shardings)
from .train import (functional_call, extract_params,  # noqa: F401
                    attach_params, ShardedTrainStep)
