"""Checkpointing: per-leaf .npy files, an async writer, integrity digests
(the counterpart of ``repro.checkpoint``)."""

from .store import CheckpointStore, latest_step, leaves, restore_state, save_state, snapshot

__all__ = ["CheckpointStore", "latest_step", "leaves", "restore_state", "save_state", "snapshot"]
