"""PyTorch + CUDA port of autodist-tpu (the JAX package stays the reference).

Three slices run so far.  Serving: the flagship ``transformer_lm``
through the paged continuous-batching engine and its HTTP front; on an
NVIDIA H100, decode attention runs a hand-written CUDA paged-attention
kernel and weight-only int8 trees a hand-written CUDA int8 matmul.
Training: the AutoDist facade (``autodist.AutoDist`` with the
``AllReduce`` strategy, data parallel over ``torch.distributed``), where
every transformer attends through hand-written CUDA flash-attention
kernels (forward, dQ, dK/dV).  ZeRO-1 and the numerics guard: the
``Zero1`` strategy's bucketed step with sharded optimizer state, and
``capture(numerics=...)``'s gradient-health guard, clip and skip, with
hand-written CUDA kernels for the guard's statistics and the fused Adam
shard update.
Kernels live in ``csrc/`` and are built at first use by ``ops/_build.py``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
