"""Fault-tolerance hooks of the serving tier (PyTorch counterpart of
``repro.distributed.fault``). Sharded retrieval (``retrieval``, ROADMAP
A4) and the training partition rules (``sharding``, A7) are not ported."""
from .fault import (
    HeartbeatRegistry,
    PreemptionGuard,
    ReplicaTracker,
    StepMonitor,
)

__all__ = [
    "HeartbeatRegistry",
    "PreemptionGuard",
    "ReplicaTracker",
    "StepMonitor",
]
