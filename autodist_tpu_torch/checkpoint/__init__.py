"""Checkpointing: the :class:`Saver` (save, verify, restore, verified-good
steps and rollback), :func:`save_params`, and the model export
(:class:`SavedModelBuilder`, :func:`load_saved_model`: a ``torch.export``
program and its parameters).

Port of the JAX package's ``checkpoint/``, with its RAM and peer
checkpoint tiers and restore routing (``tiers.py``).
"""
from autodist_tpu_torch.checkpoint.saved_model_builder import (
    SavedModelBuilder, load_saved_model)
from autodist_tpu_torch.checkpoint.saver import Saver, save_params
from autodist_tpu_torch.checkpoint.tiers import (CheckpointTiers, PeerMirror,
                                                 RamSnapshot, SnapshotError,
                                                 SnapshotRing, buddy_of,
                                                 capture_snapshot,
                                                 load_snapshot, route_restore,
                                                 snapshot_from_bytes,
                                                 snapshot_to_bytes)

__all__ = ["CheckpointTiers", "PeerMirror", "RamSnapshot",
           "SavedModelBuilder", "Saver", "SnapshotError", "SnapshotRing",
           "buddy_of", "capture_snapshot", "load_saved_model",
           "load_snapshot", "route_restore", "save_params",
           "snapshot_from_bytes", "snapshot_to_bytes"]
