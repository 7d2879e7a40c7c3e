"""Device placement, mesh and multi-process runtime for the port (the
counterpart of predictionio_tpu.parallel): one device per process, a
``torch.distributed`` world over the processes, and the mesh's axes over
the ranks."""

from predictionio_torch.parallel.context import DeviceContext, resolve_device
from predictionio_torch.parallel.mesh import (
    MeshContext,
    create_mesh,
    local_device_count,
    named_sharding,
    replicated,
)
from predictionio_torch.parallel.multihost import (
    all_hosts_sum,
    exchange_columns,
    global_array,
    host_shard_by_entity,
    host_shard_slice,
    initialize_from_env,
)

__all__ = [
    "DeviceContext",
    "resolve_device",
    "MeshContext",
    "create_mesh",
    "local_device_count",
    "named_sharding",
    "replicated",
    "all_hosts_sum",
    "exchange_columns",
    "global_array",
    "host_shard_by_entity",
    "host_shard_slice",
    "initialize_from_env",
]
