"""Checkpointing: the :class:`Saver` (save, verify, restore, verified-good
steps and rollback), :func:`save_params`, and the model export
(:class:`SavedModelBuilder`, :func:`load_saved_model`: a ``torch.export``
program and its parameters).

Port of the JAX package's ``checkpoint/``.  The RAM and peer checkpoint
tiers (``tiers.py``) are P9's and raise when used.
"""
from autodist_tpu_torch.checkpoint.saved_model_builder import (
    SavedModelBuilder, load_saved_model)
from autodist_tpu_torch.checkpoint.saver import Saver, save_params

__all__ = ["SavedModelBuilder", "Saver", "load_saved_model", "save_params"]
