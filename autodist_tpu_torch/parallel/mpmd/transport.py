"""Activation/gradient transport plane between MPMD stage programs.

Port of ``autodist_tpu/parallel/mpmd/transport.py``, with its blob format
(the ``ADTPUACT1`` magic, a sha256 header, an ``np.save`` payload): a
blob one package writes, the other reads.  The plane is on the host, as
in the JAX package: a stage's output is staged through host memory
whatever device computed it.

Stages are SEPARATE processes (separate ``torch.distributed`` worlds), so
boundary activations and cotangents move over DCN, not over a mesh
axis.  The wire is the retry-transport idiom of the peer checkpoint
tier (``checkpoint/tiers.py`` ``PeerMirror``): atomic
tmp+``os.replace`` publishes, a digest header so a torn or corrupt blob
is SKIPPED and re-polled rather than half-read, and
a cluster's ``remote_copy`` / ``remote_fetch`` (each with the cluster's
retry schedule) when the peer stage lives on another host.

Two paths, one API:

* **in-memory fast path** — stages in one process (tests, bench, the
  thread-backed runners) rendezvous through a process-local registry
  under a condition variable: no filesystem, no polling.
* **directory path** — stages in separate processes share
  ``AUTODIST_MPMD_DIR`` (tmpfs in production); ``recv`` polls with a
  deadline (``AUTODIST_MPMD_TIMEOUT_S``) so a dead upstream stage
  surfaces as :class:`TransportTimeout`, which the supervisor turns
  into a stage restart (docs/pipeline.md).

Buffer names are the schedule IR's ``act:`` buffer spellings
(``act:pipe/f0@3``) — the same strings the verifier's
``schedule/act-transport`` rule pairs and the liveness watermark
tracks, so a wedged transport names an IR buffer, not a private path.
"""
from __future__ import annotations

import hashlib
import io
import os
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging

#: default recv deadline when neither the constructor nor
#: ``AUTODIST_MPMD_TIMEOUT_S`` says otherwise.
DEFAULT_TIMEOUT_S = 120.0

_MAGIC = b"ADTPUACT1"


class TransportTimeout(TimeoutError):
    """No valid blob for the buffer arrived before the deadline."""


# -- in-process rendezvous registry (the fast path) ---------------------------

_LOCK = threading.Condition()
_REGISTRY: Dict[Tuple[str, str], bytes] = {}


def _registry_put(scope: str, buf: str, blob: bytes) -> None:
    with _LOCK:
        _REGISTRY[(scope, buf)] = blob
        _LOCK.notify_all()


def _registry_take(scope: str, buf: str, deadline: float
                   ) -> Optional[bytes]:
    with _LOCK:
        while (scope, buf) not in _REGISTRY:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            _LOCK.wait(min(remaining, 0.25))
        return _REGISTRY.pop((scope, buf))


def reset_registry() -> None:
    """Test hook: drop every in-flight in-memory buffer."""
    with _LOCK:
        _REGISTRY.clear()
        _LOCK.notify_all()


def _encode(value: Any) -> bytes:
    bio = io.BytesIO()
    np.save(bio, np.asarray(value), allow_pickle=False)
    payload = bio.getvalue()
    digest = hashlib.sha256(payload).hexdigest().encode()
    return _MAGIC + b" " + digest + b"\n" + payload


def _decode(blob: bytes) -> Optional[np.ndarray]:
    """Payload array, or None when the blob is torn/corrupt (header
    missing or digest mismatch) — the caller re-polls."""
    head, sep, payload = blob.partition(b"\n")
    if not sep or not head.startswith(_MAGIC + b" "):
        return None
    digest = head[len(_MAGIC) + 1:]
    if hashlib.sha256(payload).hexdigest().encode() != digest:
        return None
    try:
        return np.load(io.BytesIO(payload), allow_pickle=False)
    except Exception:
        return None


def _safe(buf: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in buf)


class ActivationTransport:
    """One stage process's window onto the DCN activation plane.

    Args:
      directory: shared directory for cross-process blobs (default:
        ``AUTODIST_MPMD_DIR``; empty = in-memory only, which reaches
        only stages in THIS process).
      channel: disambiguates replicas of the same pipeline — data-
        parallel rank r of every stage passes ``channel="dp<r>"`` so
        the per-replica transport grids never collide while all
        replicas keep the same IR buffer names (SPMD within a stage).
      cluster / peers: an optional cluster (any object with
        ``remote_copy(src, dst, address)`` and ``remote_fetch(src, dst,
        address)``; the port's ``Cluster`` is ROADMAP P12's) plus
        ``{stage_name: address}`` for cross-host pipelines — sends push
        the published blob to the consuming stage's host with the
        cluster's retry schedule (the ``PeerMirror`` push path).
      timeout_s: recv deadline (default ``AUTODIST_MPMD_TIMEOUT_S`` or
        :data:`DEFAULT_TIMEOUT_S`).
    """

    def __init__(self, directory: Optional[str] = None, *,
                 channel: str = "", cluster: Any = None,
                 peers: Optional[Dict[str, str]] = None,
                 timeout_s: Optional[float] = None,
                 poll_s: float = 0.002):
        if directory is None:
            directory = ENV.AUTODIST_MPMD_DIR.val or ""
        self.directory = directory
        self.channel = channel or ""
        self._cluster = cluster
        self._peers = dict(peers or {})
        env_t = ENV.AUTODIST_MPMD_TIMEOUT_S.val
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else (env_t or DEFAULT_TIMEOUT_S))
        self.poll_s = float(poll_s)
        self._scope = f"{self.directory}|{self.channel}"
        if self.directory:
            os.makedirs(self._dir(), exist_ok=True)

    def _dir(self) -> str:
        return os.path.join(self.directory, self.channel) \
            if self.channel else self.directory

    def _path(self, buf: str) -> str:
        return os.path.join(self._dir(), _safe(buf) + ".act")

    # -- send -----------------------------------------------------------------

    def send(self, buf: str, value: Any, *, to_stage: str = "") -> None:
        """Publish ``value`` under the IR buffer name ``buf``.

        Always lands in the in-process registry (the fast path); when a
        directory is configured the blob is ALSO published atomically
        there (tmp + ``os.replace``, the torn-write-proof idiom), and —
        when ``to_stage`` maps to a remote peer — pushed to that host.
        """
        blob = _encode(value)
        _registry_put(self._scope, buf, blob)
        if not self.directory:
            return
        final = self._path(buf)
        fd, tmp = tempfile.mkstemp(dir=self._dir(), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, final)   # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        addr = self._peers.get(to_stage) if to_stage else None
        if addr and self._cluster is not None:
            self._cluster.remote_copy(final, final, addr)

    # -- recv -----------------------------------------------------------------

    def recv(self, buf: str, *, from_stage: str = "",
             timeout_s: Optional[float] = None) -> np.ndarray:
        """Block until a VALID blob for ``buf`` exists; consume it.

        The in-process registry is checked first (and woken by sends);
        the directory is polled otherwise.  A corrupt or torn blob is
        skipped and re-polled — upstream retransmits land under the
        same name via atomic replace.  Directory blobs are NOT deleted
        on consume: they persist until the producer's per-step
        :meth:`gc`, so a chaos-killed stage restarted mid-step re-reads
        the step's published activations instead of deadlocking its
        peers (the recovery drill in tests/integration/mpmd_train.py).
        Raises :class:`TransportTimeout` past the deadline (naming the
        IR buffer, so the supervisor's hang report and the transport
        error point at the same leg).
        """
        deadline = time.monotonic() + float(
            timeout_s if timeout_s is not None else self.timeout_s)
        if not self.directory:
            blob = _registry_take(self._scope, buf, deadline)
            if blob is None:
                raise TransportTimeout(
                    f"transport recv timed out waiting for {buf!r} "
                    f"(in-memory, {self.timeout_s:g}s)")
            val = _decode(blob)
            if val is None:
                raise TransportTimeout(
                    f"transport blob for {buf!r} is corrupt (in-memory)")
            return val
        path = self._path(buf)
        addr = self._peers.get(from_stage) if from_stage else None
        warned = False
        while True:
            with _LOCK:
                blob = _REGISTRY.pop((self._scope, buf), None)
            if blob is None and os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        blob = f.read()
                except OSError:
                    blob = None
            if blob is not None:
                val = _decode(blob)
                if val is not None:
                    return val
                if not warned:
                    logging.warning(
                        "transport: skipping corrupt blob for %s "
                        "(digest mismatch); re-polling", buf)
                    warned = True
            if time.monotonic() >= deadline:
                raise TransportTimeout(
                    f"transport recv timed out waiting for {buf!r} "
                    f"under {self._dir()}")
            if addr and self._cluster is not None:
                try:      # remote pull (retry schedule inside the cluster)
                    self._cluster.remote_fetch(path, path, addr)
                except Exception:
                    pass  # not there yet; keep polling
            time.sleep(self.poll_s)

    # -- housekeeping ---------------------------------------------------------

    def gc(self, prefix: str) -> int:
        """Drop every published buffer whose name starts with ``prefix``
        (e.g. a completed step's namespace); returns the count."""
        n = 0
        with _LOCK:
            for key in [k for k in _REGISTRY
                        if k[0] == self._scope and k[1].startswith(prefix)]:
                del _REGISTRY[key]
                n += 1
        if self.directory and os.path.isdir(self._dir()):
            tag = _safe(prefix)
            for name in os.listdir(self._dir()):
                if name.startswith(tag) and name.endswith(".act"):
                    try:
                        os.unlink(os.path.join(self._dir(), name))
                        n += 1
                    except OSError:
                        pass
        return n
