"""Distribution (PyTorch counterpart of ``repro.distributed``):
fault-tolerance hooks (``fault``), the device mesh (``mesh``), sharded
retrieval over it (``retrieval``), the training partition rules
(``sharding``) and tensors laid out by them with their collectives
(``partition``)."""
from .fault import (
    HeartbeatRegistry,
    PreemptionGuard,
    ReplicaTracker,
    StepMonitor,
)
from .mesh import Mesh, make_mesh
from .retrieval import (
    ShardedRows,
    host_rows,
    shard_rows,
    sharded_ivf_probe,
    sharded_knn_search,
)

__all__ = [
    "HeartbeatRegistry",
    "Mesh",
    "PreemptionGuard",
    "ReplicaTracker",
    "ShardedRows",
    "StepMonitor",
    "host_rows",
    "make_mesh",
    "shard_rows",
    "sharded_ivf_probe",
    "sharded_knn_search",
]
