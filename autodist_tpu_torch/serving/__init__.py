"""Serving: the continuous-batching engines and their HTTP front.

Public names mirror the JAX package's ``serving`` for what is ported:
the slot :class:`DecodeEngine` (``serve()``'s default), the paged KV
stack (:class:`BlockPool`, :class:`PrefixTrie`) and
:class:`PagedDecodeEngine` (SLO queues, block-budget admission, prefix
reuse, chunked prefill, deadlines, speculative decoding), and the stdlib
HTTP server in front of either.  The replica router and the drain
machinery come in a later slice.
"""
from autodist_tpu_torch.serving.engine import (AdmissionError, DeadlineError,
                                               DecodeEngine, EngineStats,
                                               Request)
from autodist_tpu_torch.serving.paged_kv import (BlockPool,
                                                 BlockPoolExhausted,
                                                 PrefixTrie)
from autodist_tpu_torch.serving.scheduler import (SLO_CLASSES, SLO_LATENCY,
                                                  SLO_THROUGHPUT,
                                                  PagedDecodeEngine)
from autodist_tpu_torch.serving.server import EngineServer, serve

__all__ = ["AdmissionError", "DeadlineError", "DecodeEngine", "EngineStats",
           "Request", "BlockPool", "BlockPoolExhausted", "PrefixTrie",
           "PagedDecodeEngine", "SLO_CLASSES", "SLO_LATENCY",
           "SLO_THROUGHPUT", "EngineServer", "serve"]
