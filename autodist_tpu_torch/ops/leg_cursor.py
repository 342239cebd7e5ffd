"""Stream-ordered leg cursors for the flight recorder (``csrc/leg_cursor.cu``).

:func:`stamp` marks a schedule-IR leg boundary of the training step.  On a
CUDA device it launches the one-thread leg-cursor kernel on the current
stream, which writes the stamp's sequence number and ``%globaltimer`` into
a ring in mapped pinned host memory when the card gets there (every kernel
enqueued before it has finished); the flight recorder reads the ring
without a synchronization (:func:`drain`, registered as a cursor source of
:mod:`~autodist_tpu_torch.telemetry.flightrec`), so its cursors name the
leg the DEVICE reached, not the last one the host enqueued.  On the CPU
the stamp is the plain version, :func:`~autodist_tpu_torch.telemetry.
flightrec.record_cursor` at once (the host IS the device there).

``stamp.calls`` counts the stamps that launched the kernel (the CPU's
plain stamps are not counted).
"""
from __future__ import annotations

import ctypes
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: slots of the cursor ring per device (a step stamps a few per bucket)
CAPACITY = 4096
_SOURCE = "leg_cursor.cu"
_ALLOC_ARGS = (ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p),
               ctypes.POINTER(ctypes.c_void_p))
_STAMP_ARGS = (ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_uint,
               ctypes.c_void_p)

_lock = threading.Lock()
_rings: Dict[int, "_Ring"] = {}


class _Ring:
    """One device's ring: the mapped host buffer, the host's record of
    what each enqueued stamp names, and the clock offset that turns the
    card's ``%globaltimer`` into this process's monotonic clock."""

    def __init__(self, device: torch.device):
        from autodist_tpu_torch.ops import _build

        self.device = device
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        alloc = _build.kernel(_SOURCE, "leg_cursor_alloc", _ALLOC_ARGS)
        with torch.cuda.device(device):
            err = alloc(CAPACITY, ctypes.byref(host), ctypes.byref(dev))
        if err:
            raise RuntimeError(f"leg_cursor_alloc failed (cudaError {err})")
        self._host, self._dev = host.value, dev.value
        self.words = np.ctypeslib.as_array(
            ctypes.cast(self._host, ctypes.POINTER(ctypes.c_ulonglong)),
            shape=(CAPACITY, 2))
        self.names: List[Optional[Tuple]] = [None] * CAPACITY
        self.enqueued = 0
        self.drained = 0
        self._fn = _build.kernel(_SOURCE, "leg_cursor_stamp", _STAMP_ARGS)
        self.offset_s = 0.0
        self._calibrate()

    def launch(self, names: Tuple) -> int:
        seq = self.enqueued
        self.names[seq % CAPACITY] = names
        with torch.cuda.device(self.device):
            err = self._fn(self._dev, seq, CAPACITY,
                           torch.cuda.current_stream(self.device).cuda_stream)
        if err:
            raise RuntimeError(f"leg_cursor_stamp launch failed "
                               f"(cudaError {err})")
        self.enqueued = seq + 1
        return seq

    def _calibrate(self) -> None:
        """One stamp, waited for: its device time against the host's
        monotonic clock just after (an offset good to the wait's
        microseconds)."""
        seq = self.launch(("~calibrate", "", -1, None))
        torch.cuda.synchronize(self.device)
        t_host = time.monotonic()
        self.offset_s = t_host - float(self.words[seq % CAPACITY, 1]) * 1e-9
        self.drained = self.enqueued

    def completed(self) -> List[Tuple[Tuple, float]]:
        """``(names, monotonic time)`` of every stamp the card has
        reached since the last call, in stream order (no synchronization:
        reads of the mapped ring)."""
        out = []
        seq = max(self.drained, self.enqueued - CAPACITY)
        while seq < self.enqueued:
            row = self.words[seq % CAPACITY]
            if int(row[0]) != seq + 1:
                break
            out.append((self.names[seq % CAPACITY],
                        float(row[1]) * 1e-9 + self.offset_s))
            seq += 1
        self.drained = seq
        return out


def _ring(device: torch.device) -> _Ring:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    ring = _rings.get(index)
    if ring is None:
        with _lock:
            ring = _rings.get(index)
            if ring is None:
                from autodist_tpu_torch.telemetry import flightrec

                ring = _rings[index] = _Ring(torch.device("cuda", index))
                flightrec.add_cursor_source(drain)
    return ring


def stamp(device, leg: str, *, leg_kind: str = "", slot: int = -1,
          fingerprint: Optional[str] = None) -> None:
    """Stamp ``leg`` (a leg id; microbatch ``slot``, -1 at the end of the
    step) when the device reaches this point of its stream: the leg-cursor
    kernel on a CUDA ``device``, the plain :func:`~autodist_tpu_torch.
    telemetry.flightrec.record_cursor` on the CPU.  ``fingerprint``: the
    schedule the stamp belongs to (the recorder's current one on the
    CPU)."""
    from autodist_tpu_torch.telemetry import flightrec

    device = torch.device(device)
    if device.type != "cuda":
        flightrec.record_cursor(leg, leg_kind=leg_kind, slot=slot)
        return
    _ring(device).launch((leg, leg_kind, int(slot), fingerprint))
    stamp.calls += 1


#: launches of the leg-cursor kernel since the last reset
stamp.calls = 0


def drain() -> List[dict]:
    """The cursors every device has reached since the last drain, as
    :class:`~autodist_tpu_torch.telemetry.flightrec.Cursor` fields (the
    flight recorder's cursor source)."""
    out = []
    for ring in list(_rings.values()):
        for (leg, leg_kind, slot, fp), t_mono in ring.completed():
            if leg == "~calibrate":
                continue
            out.append({"leg": leg, "leg_kind": leg_kind, "slot": slot,
                        "fingerprint": fp, "t_mono": t_mono,
                        "t_unix": time.time() - (time.monotonic() - t_mono)})
    return out


def enqueued_leg(device) -> Optional[str]:
    """The leg of the last stamp the host ENQUEUED on ``device`` (what a
    host-side stamp would report), or None."""
    ring = _rings.get(torch.device(device).index or 0)
    if ring is None or not ring.enqueued:
        return None
    names = ring.names[(ring.enqueued - 1) % CAPACITY]
    return None if names is None or names[0] == "~calibrate" else names[0]
