"""Atomic, asynchronous checkpoints with a CRC32 per leaf."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruptionError,
    CheckpointManager,
)
