"""PyTorch + CUDA port of autodist-tpu (the JAX package stays the reference).

The public surface is the JAX package's: ``AutoDist(resource_spec,
strategy_builder)``, ``ResourceSpec``, ``DeviceSpec``, ``ENV``,
``__version__``, and ``fit``'s ``Callback``, ``TimeHistory`` and
``History`` (the facade and the callbacks exported lazily: they pull in
the training stack).

Serving: the flagship ``transformer_lm``
through the paged continuous-batching engine and its HTTP front; on an
NVIDIA H100, decode attention runs a hand-written CUDA paged-attention
kernel and weight-only int8 trees a hand-written CUDA int8 matmul.
Training: the facade with the ``AllReduce`` strategy (data parallel over
``torch.distributed``), where every transformer attends through
hand-written CUDA flash-attention kernels (forward, dQ, dK/dV) on the
tensor cores.  ZeRO-1 and the numerics guard: the ``Zero1`` strategy's
bucketed step with sharded optimizer state, and ``capture(numerics=...)``'s
gradient-health guard, clip and skip, with hand-written CUDA kernels for
the guard's statistics and the fused Adam shard update.  The quantized
wire: ``Int8Compressor``/``Fp8Compressor`` with ``overlap="ring"``, with
hand-written CUDA quantize, hop-accumulate and dequant-add kernels.
The PS family and the BASELINE models train on the same steps, and
``DistributedSession.fit`` drives them through epochs with callbacks,
checkpoints (``checkpoint.Saver``), exact resume and the numerics
rollback.  ``telemetry`` records every step, the sync legs' profiler
ranges, goodput and the event journal, in the JAX package's formats.
Kernels live in ``csrc/`` and are built at first use by ``ops/_build.py``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from autodist_tpu_torch.const import ENV  # noqa: F401
from autodist_tpu_torch.resource_spec import (DeviceSpec,  # noqa: F401
                                              ResourceSpec)

__version__ = "0.1.0"

__all__ = ["AutoDist", "ResourceSpec", "DeviceSpec", "ENV", "Callback",
           "TimeHistory", "History", "__version__"]


def __getattr__(name):
    # Lazy: the facade imports the training stack; keep the package light.
    if name == "AutoDist":
        from autodist_tpu_torch.autodist import AutoDist
        return AutoDist
    if name in ("Callback", "TimeHistory", "History"):
        from autodist_tpu_torch import fit
        return getattr(fit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
