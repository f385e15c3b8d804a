"""Versioned, atomic on-disk snapshots of serving indexes (``index_io``) and
the trainer's checkpoints (``checkpoint``, the reference's format)."""
from .checkpoint import CheckpointManager
from .index_io import (
    INDEX_FORMAT,
    INDEX_FORMAT_VERSION,
    READABLE_VERSIONS,
    CheckpointFormatError,
    load_state,
    save_state,
    write_json_atomic,
)

__all__ = [
    "CheckpointFormatError",
    "CheckpointManager",
    "INDEX_FORMAT",
    "INDEX_FORMAT_VERSION",
    "READABLE_VERSIONS",
    "load_state",
    "save_state",
    "write_json_atomic",
]
