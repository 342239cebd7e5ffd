"""Numerical-failure detection: the gradient-health guard, loss scaling,
exact global-norm clipping and the skip gate.

Port of the JAX package's ``numerics/``: :mod:`.guard` (``GradHealth``,
``HealthAccumulator``), :mod:`.loss_scale` (``LossScale`` and its rules)
and :mod:`.policy` (``NumericsConfig``).  Turn it on with
``AutoDist.capture(..., numerics=True)`` or a dict of ``NumericsConfig``
fields; it is off by default.  ``fit``'s host policy
(``StepHealthMonitor``, rollback) comes with P5.
"""
from autodist_tpu_torch.numerics.guard import (NUMERICS_KEY, GradHealth,
                                               HealthAccumulator)
from autodist_tpu_torch.numerics.loss_scale import (LossScale,
                                                    resolve_loss_scale,
                                                    scale_saturates_wire,
                                                    wire_dtype_of)
from autodist_tpu_torch.numerics.policy import (ON_NONFINITE, NonFiniteError,
                                                NumericsConfig)

__all__ = ["GradHealth", "HealthAccumulator", "LossScale", "NUMERICS_KEY",
           "NonFiniteError", "NumericsConfig", "ON_NONFINITE",
           "resolve_loss_scale", "scale_saturates_wire", "wire_dtype_of"]
