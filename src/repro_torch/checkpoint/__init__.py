"""Checkpointing of the port (``CheckpointManager``)."""
