"""Fault-tolerant checkpointing of the port: atomic npz snapshots in the JAX
package's key layout and auto-resume; counterpart of ``repro.checkpoint``
(one device: no ``restore_sharded``)."""
from .checkpoint import CheckpointManager, latest_step, load_into, restore, save

__all__ = ["CheckpointManager", "latest_step", "load_into", "restore", "save"]
