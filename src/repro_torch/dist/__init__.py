"""Data-parallel training over the int8 wire (counterpart of
``repro/dist``): the compressed collectives and the transports they run
over.  ZeRO-1 sharding and the bucketed overlap are not ported yet."""

from repro_torch.dist.collectives import (  # noqa: F401
    GroupLayout, TreeAllReduce, WIRE_BITS, WIRE_GROUP_QUANTUM,
    default_wire_quantum, dps_allreduce_mean, dps_allreduce_mean_tree,
    group_layout, psum_stats, resolve_domain_format, wire_decode, wire_encode,
    wire_format)
from repro_torch.dist.transport import (  # noqa: F401
    ProcessGroupTransport, StackedTransport)
