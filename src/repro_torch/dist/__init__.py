"""Distribution (counterpart of ``repro/dist``): the logical placement
rules and the mesh context (``LogicalRules``, ``axis_rules``,
``logical_constraint``, ``tree_specs``), the compressed collectives of the
int8 wire, the transports they run over, the ZeRO-1 flat layouts and the
bucketed (backward-overlapped) wire."""

from repro_torch.dist.collectives import (  # noqa: F401
    F32TreeMean, GroupLayout, TreeAllReduce, WIRE_BITS, WIRE_GROUP_QUANTUM,
    default_wire_quantum, dps_allgather_params, dps_allreduce_mean,
    dps_allreduce_mean_tree, dps_reduce_scatter_mean, group_layout,
    psum_stats, resolve_domain_format, wire_decode, wire_encode, wire_format)
from repro_torch.dist.overlap import (  # noqa: F401
    DEFAULT_BUCKET_ELEMS, BucketPlan, BucketedWire,
    bucketed_allreduce_mean_tree, plan_buckets, zero_allgather_params,
    zero_bucketed_reduce_scatter)
from repro_torch.dist.sharding import (  # noqa: F401
    GroupAlignedPartitioner, LogicalRules, StackedMesh, ZeroPartitioner,
    axis_rules, current_mesh_rules, local_block, logical_constraint,
    model_axis_size, tree_specs)
from repro_torch.dist.transport import (  # noqa: F401
    ProcessGroupTransport, StackedTransport)
