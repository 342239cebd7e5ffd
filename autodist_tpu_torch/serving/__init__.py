"""Serving: the continuous-batching engines and their HTTP front.

Public names mirror the JAX package's ``serving`` for what is ported:
the slot :class:`DecodeEngine` (``serve()``'s default), the paged KV
stack (:class:`BlockPool`, :class:`PrefixTrie`) and
:class:`PagedDecodeEngine` (SLO queues, block-budget admission, prefix
reuse, chunked prefill, deadlines, speculative decoding), and the stdlib
HTTP server in front of either (with the graceful drain:
``/admin/drain``, SIGTERM, :func:`install_drain_on_sigterm`), and the
:class:`Router` + :class:`SupervisedReplicaPool` pair: N replicas
supervised through the resilience machinery, queue-depth and
block-headroom load balancing, re-routing and token-exact mid-decode
recovery, circuit breakers, deadline shedding and hedging.
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
from autodist_tpu_torch.serving.router import (Router, RouterBusy,
                                               RouterDeadlineError,
                                               RouterError,
                                               RouterRequestError,
                                               SupervisedReplicaPool)
from autodist_tpu_torch.serving.server import (EngineServer,
                                               install_drain_on_sigterm,
                                               serve)

__all__ = ["AdmissionError", "DeadlineError", "DecodeEngine", "EngineStats",
           "Request", "BlockPool", "BlockPoolExhausted", "PrefixTrie",
           "PagedDecodeEngine", "SLO_CLASSES", "SLO_LATENCY",
           "SLO_THROUGHPUT", "Router", "RouterBusy", "RouterDeadlineError",
           "RouterError", "RouterRequestError", "SupervisedReplicaPool",
           "EngineServer", "install_drain_on_sigterm", "serve"]
