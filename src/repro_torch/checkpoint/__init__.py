"""Checkpointing (``repro.checkpoint``): the reference's file format."""
from repro_torch.checkpoint.checkpointer import CheckpointConfig, Checkpointer

__all__ = ["Checkpointer", "CheckpointConfig"]
