"""Fault-tolerant checkpointing of the port: atomic npz snapshots of full
arrays in the JAX package's key layout, auto-resume and elastic resharding;
counterpart of ``repro.checkpoint``."""
from .checkpoint import (CheckpointManager, latest_step, load_into, restore,
                         restore_sharded, save)

__all__ = ["CheckpointManager", "latest_step", "load_into", "restore", "restore_sharded",
           "save"]
