"""PyTorch + CUDA port of autodist-tpu (the JAX package stays the reference).

This slice serves the flagship ``transformer_lm`` through the paged
continuous-batching engine and its HTTP front.  On an NVIDIA H100, decode
attention runs a hand-written CUDA paged-attention kernel and weight-only
int8 trees run a hand-written CUDA int8 matmul (``csrc/``, built at first
use by ``ops/_build.py``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
