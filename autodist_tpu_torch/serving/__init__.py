"""Serving: the paged continuous-batching engine and its HTTP front.

Public names mirror the JAX package's ``serving`` for what is ported:
the paged KV stack (:class:`BlockPool`, :class:`PrefixTrie`) and
:class:`PagedDecodeEngine` (SLO queues, block-budget admission, prefix
reuse, chunked prefill, deadlines), and the stdlib HTTP server in front
of it.  The slot engine, speculative decoding, the router and the drain
machinery come in later slices.
"""
from autodist_tpu_torch.serving.engine import AdmissionError, DeadlineError
from autodist_tpu_torch.serving.paged_kv import (BlockPool,
                                                 BlockPoolExhausted,
                                                 PrefixTrie)
from autodist_tpu_torch.serving.scheduler import (SLO_CLASSES, SLO_LATENCY,
                                                  SLO_THROUGHPUT,
                                                  PagedDecodeEngine)
from autodist_tpu_torch.serving.server import EngineServer, serve

__all__ = ["AdmissionError", "DeadlineError", "BlockPool",
           "BlockPoolExhausted", "PrefixTrie", "PagedDecodeEngine",
           "SLO_CLASSES", "SLO_LATENCY", "SLO_THROUGHPUT", "EngineServer",
           "serve"]
