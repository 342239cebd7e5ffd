"""Checkpointing: the :class:`Saver` (save, verify, restore, verified-good
steps and rollback) and :func:`save_params`.

Port of the JAX package's ``checkpoint/``.  ``SavedModelBuilder``
(``saved_model_builder.py``, the StableHLO export) is its own ROADMAP
item, and the RAM and peer checkpoint tiers (``tiers.py``) are P9's; both
raise when used.
"""
from autodist_tpu_torch.checkpoint.saver import Saver, save_params
from autodist_tpu_torch.const import unported_class

SavedModelBuilder = unported_class(
    "SavedModelBuilder", "autodist_tpu_torch.checkpoint.SavedModelBuilder",
    "saved_model_builder — the model export")

__all__ = ["SavedModelBuilder", "Saver", "save_params"]
