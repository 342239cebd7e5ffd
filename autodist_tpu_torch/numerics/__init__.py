"""Numerical-failure detection: the gradient-health guard, loss scaling,
exact global-norm clipping and the skip gate.

Port of the JAX package's ``numerics/``: :mod:`.guard` (``GradHealth``,
``HealthAccumulator``), :mod:`.loss_scale` (``LossScale`` and its rules)
and :mod:`.policy` (``NumericsConfig``).  Turn it on with
``AutoDist.capture(..., numerics=True)`` or a dict of ``NumericsConfig``
fields; it is off by default.  ``fit``'s host policy
(:class:`StepHealthMonitor`: raise, or roll back to the last
verified-good checkpoint) is in :mod:`.policy`.
"""
from autodist_tpu_torch.numerics.guard import (NUMERICS_KEY, GradHealth,
                                               HealthAccumulator)
from autodist_tpu_torch.numerics.loss_scale import (LossScale,
                                                    resolve_loss_scale,
                                                    scale_saturates_wire,
                                                    wire_dtype_of)
from autodist_tpu_torch.numerics.policy import (NUMERICS_MARKER_CODE,
                                                ON_NONFINITE, NonFiniteError,
                                                NumericsConfig,
                                                StepHealthMonitor)

__all__ = ["GradHealth", "HealthAccumulator", "LossScale", "NUMERICS_KEY",
           "NUMERICS_MARKER_CODE", "NonFiniteError", "NumericsConfig",
           "ON_NONFINITE", "StepHealthMonitor",
           "resolve_loss_scale", "scale_saturates_wire", "wire_dtype_of"]
