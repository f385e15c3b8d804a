"""Optimiser substrate of the port: AdamW, schedules, gradient compression."""
from .adamw import AdamW, AdamWState, apply_updates, clip_by_global_norm
from .compression import (
    CompressionState,
    compress_decompress,
    error_feedback_update,
)
from .schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "AdamW",
    "AdamWState",
    "apply_updates",
    "clip_by_global_norm",
    "constant",
    "cosine_decay",
    "linear_warmup_cosine",
    "CompressionState",
    "compress_decompress",
    "error_feedback_update",
]
