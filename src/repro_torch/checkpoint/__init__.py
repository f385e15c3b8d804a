"""Versioned, atomic on-disk snapshots of serving indexes."""
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
    "INDEX_FORMAT",
    "INDEX_FORMAT_VERSION",
    "READABLE_VERSIONS",
    "load_state",
    "save_state",
    "write_json_atomic",
]
