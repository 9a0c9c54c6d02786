"""Checkpoint substrate of the port: async atomic saves, the JAX package's
on-disk format."""
from repro_torch.checkpoint.manager import FORMAT_VERSION, CheckpointManager

__all__ = ["CheckpointManager", "FORMAT_VERSION"]
