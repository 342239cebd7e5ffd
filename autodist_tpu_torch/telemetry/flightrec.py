"""Flight recorder: progress cursors, hang localization, crash bundles.

Port of the JAX package's ``telemetry/flightrec.py``, the always-on black
box that turns DEAD/WEDGED/crash verdicts into localized diagnoses:

* **Progress cursors** — each process stamps :class:`Cursor`\\ s (leg
  or phase, microbatch slot, monotonic timestamp) into a lock-free
  in-process :class:`CursorRing`.  The session stamps step enter/exit
  phase cursors (one object + one list store per stamp).  The latest
  cursor rides a heartbeat beacon (:func:`beacon_cursor`).  Cursors
  carry the session's schedule-IR fingerprint (:func:`set_fingerprint`),
  and the session publishes its IR into the run directory
  (:func:`publish_ir`).  Under ``AUTODIST_FLIGHTREC=legs`` the bucketed
  step also stamps leg cursors at the IR's leg boundaries, under the
  IR's leg ids (:func:`traced_stamp`).  On the card such a stamp is
  stream-ordered: a one-thread kernel (``ops/leg_cursor.py``) writes it
  into mapped host memory when the device reaches the leg, and the
  recorder pulls the stamps the device has reached into the ring
  whenever the ring is read (:func:`add_cursor_source`), so a hang is
  blamed on the leg the device reached, not on the last one the host
  enqueued.
* **Hang localization** — :func:`localize_hang` diffs per-host cursors
  against a schedule's happens-before relation (a pure ancestor-set
  reachability over the IR's legs, given as the JSON a schedule IR
  writes) and names the frontier leg(s) and the culprit host(s).
* **Crash bundles** — :func:`dump_bundle` snapshots the event-journal
  tail, StepRecord tail, cursor rings, all-thread faulthandler stacks,
  a published schedule IR and the monitor verdicts into one
  ``bundle-<ts>/`` directory; :func:`install_fatal_handlers` arms
  faulthandler + an excepthook bundle for fatal signals and uncaught
  crashes.  ``python -m autodist_tpu_torch.telemetry --hang-report
  <bundle>`` renders one.

Everything here is the standard library (the card's stamps are imported
only where a stamp is made on the card): the CLI runs it anywhere.
"""
from __future__ import annotations

import faulthandler
import glob
import json
import os
import shutil
import socket
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: default cursor-ring capacity (cursors kept per process).
CURSOR_RING_SIZE = 512
#: microbatch-slot value for end-of-step (non-pipelined) cursors —
#: the JAX package's ``schedule_ir.END_OF_STEP``.
END_OF_STEP = -1
#: journal event kind carrying a hang diagnosis.
EVENT_HANG = "flightrec/hang"
#: crash-bundle directory prefix under the run directory.
BUNDLE_PREFIX = "bundle-"

_CURSOR_KINDS = ("leg", "phase")


def _host() -> str:
    return socket.gethostname().replace("/", "_").replace(":", "_")


@dataclass
class Cursor:
    """One progress stamp: where this process was, when.

    ``leg`` is a schedule-IR leg id for ``kind="leg"`` cursors (the
    runtime-path stamps and chaos-planted wedges) or a host-phase name
    (``"step"``, ``"checkpoint/save"``) for ``kind="phase"``.
    ``t_mono`` is the process monotonic clock — ages computed by the
    SAME process (the beacon writer) are exact; ``t_unix`` is advisory
    wall time for cross-host display only."""

    leg: str
    kind: str = "leg"
    leg_kind: str = ""              # IR leg kind when known (all_reduce, ...)
    slot: int = END_OF_STEP
    event: str = "enter"            # enter | exit
    step: Optional[int] = None
    fingerprint: Optional[str] = None
    t_mono: float = 0.0
    t_unix: float = 0.0
    seq: int = 0

    def to_dict(self) -> dict:
        d = {"leg": self.leg, "kind": self.kind, "slot": int(self.slot),
             "event": self.event, "t_mono": self.t_mono,
             "t_unix": self.t_unix, "seq": int(self.seq)}
        if self.leg_kind:
            d["leg_kind"] = self.leg_kind
        if self.step is not None:
            d["step"] = int(self.step)
        if self.fingerprint:
            d["fingerprint"] = self.fingerprint
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Cursor":
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in known})


class CursorRing:
    """Lock-free in-process cursor ring.

    ``record`` is one attribute store + one list store under the GIL —
    no lock, no allocation beyond the cursor itself — so it is safe to
    call from the training loop and from heartbeat daemon threads
    concurrently.  Overwrite semantics: the
    ring keeps the most recent ``capacity`` cursors; ``cursors()``
    returns them oldest-first."""

    def __init__(self, capacity: int = CURSOR_RING_SIZE):
        self._cap = max(int(capacity), 1)
        self._buf: List[Optional[Cursor]] = [None] * self._cap
        self._seq = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def seq(self) -> int:
        """Total cursors ever recorded (monotone)."""
        return self._seq

    def record(self, cur: Cursor) -> Cursor:
        seq = self._seq
        cur.seq = seq
        self._buf[seq % self._cap] = cur
        self._seq = seq + 1
        return cur

    def latest(self) -> Optional[Cursor]:
        seq = self._seq
        return self._buf[(seq - 1) % self._cap] if seq else None

    def cursors(self) -> List[Cursor]:
        """Oldest-first view of the retained cursors."""
        seq = self._seq
        if seq <= self._cap:
            return [c for c in self._buf[:seq] if c is not None]
        start = seq % self._cap
        out = self._buf[start:] + self._buf[:start]
        return [c for c in out if c is not None]

    def clear(self) -> None:
        self._buf = [None] * self._cap
        self._seq = 0

    def dump(self, path: str) -> Optional[str]:
        """Write the retained cursors as JSONL (never raises)."""
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                for c in self.cursors():
                    f.write(json.dumps(c.to_dict()) + "\n")
            return path
        except OSError:
            return None


# -- the process recorder ----------------------------------------------------

_ring = CursorRing()
_fingerprint: Optional[str] = None
#: callables returning the cursors a device has reached since their last
#: call (dicts of Cursor fields), pulled into the ring when it is read
_sources: List[Any] = []


def add_cursor_source(fn) -> None:
    """Register a source of device-side cursors (``ops/leg_cursor.drain``):
    every read of the ring first records what each source returns."""
    if fn not in _sources:
        _sources.append(fn)


def _pull() -> None:
    for fn in list(_sources):
        try:
            for d in fn():
                _ring.record(Cursor(kind="leg", **d))
        except Exception:  # pragma: no cover - the recorder never raises
            pass


def ring() -> CursorRing:
    _pull()
    return _ring


def set_fingerprint(fp: Optional[str]) -> None:
    """Stamp the active schedule fingerprint onto subsequent cursors
    (set once per session build)."""
    global _fingerprint
    _fingerprint = fp


def enabled() -> bool:
    """Recording is on unless telemetry is off or
    ``AUTODIST_FLIGHTREC=0``."""
    try:
        from autodist_tpu_torch.const import ENV
        from autodist_tpu_torch.telemetry.registry import telemetry_enabled

        if not telemetry_enabled():
            return False
        return (ENV.AUTODIST_FLIGHTREC.val or "").strip() != "0"
    except Exception:  # pragma: no cover - defensive
        return False


def record_cursor(leg: str, *, kind: str = "leg", leg_kind: str = "",
                  slot: int = END_OF_STEP, event: str = "enter",
                  step: Optional[int] = None) -> Optional[Cursor]:
    """Stamp one cursor into the process ring (no-op when disabled;
    never raises — the recorder must not kill training)."""
    try:
        if not enabled():
            return None
        return _ring.record(Cursor(
            leg=str(leg), kind=kind, leg_kind=leg_kind, slot=int(slot),
            event=event, step=step, fingerprint=_fingerprint,
            t_mono=time.monotonic(), t_unix=time.time()))
    except Exception:  # pragma: no cover - defensive
        return None


def latest_cursor() -> Optional[Cursor]:
    _pull()
    return _ring.latest()


def beacon_cursor() -> Optional[dict]:
    """The latest cursor as a beacon-sized dict with its age computed
    on THIS process's monotonic clock (``age_s``) — what heartbeat
    beacons carry so the monitor sees per-host progress without new
    transport.  Also refreshes the
    ``autodist_flightrec_cursor_age_seconds`` gauge."""
    cur = _ring.latest()
    if cur is None:
        return None
    age = max(time.monotonic() - cur.t_mono, 0.0)
    try:
        from autodist_tpu_torch.telemetry.registry import gauge

        gauge("autodist_flightrec_cursor_age_seconds",
              "seconds since this process stamped a flight-recorder "
              "cursor").set(age)
    except Exception:  # pragma: no cover - defensive
        pass
    out = cur.to_dict()
    out["age_s"] = round(age, 3)
    return out


def cursor_line(cursor: Optional[dict],
                extra_age_s: float = 0.0) -> str:
    """Human rendering of a beacon cursor dict: ``"in
    ring_reduce_scatter leg rs:f32:0 slot 2 for 41 s"`` ('' when
    absent).  ``extra_age_s`` adds the beacon's own age (the cursor's
    ``age_s`` was computed when the beacon was written)."""
    if not cursor or not cursor.get("leg"):
        return ""
    age = float(cursor.get("age_s") or 0.0) + max(extra_age_s, 0.0)
    if cursor.get("kind") == "phase":
        head = f"in phase {cursor['leg']}"
    else:
        lk = cursor.get("leg_kind") or ""
        head = (f"in {lk} leg {cursor['leg']}" if lk
                else f"in leg {cursor['leg']}")
    slot = cursor.get("slot")
    if slot is not None and int(slot) >= 0:
        head += f" slot {int(slot)}"
    if cursor.get("step") is not None:
        head += f" (step {int(cursor['step'])})"
    return head + f" for {age:.0f} s"


def dump_cursors(directory: str) -> Optional[str]:
    """Flush this process's ring as ``cursors-<host>-<pid>.jsonl``
    under ``directory`` (the per-host half of a crash bundle)."""
    if not directory:
        return None
    _pull()
    return _ring.dump(os.path.join(
        directory, f"cursors-{_host()}-{os.getpid()}.jsonl"))


def load_cursors(path: str) -> List[Cursor]:
    out: List[Cursor] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(Cursor.from_dict(json.loads(line)))
                except (ValueError, TypeError):
                    continue
    except OSError:
        pass
    return out


def reset_for_testing() -> None:
    global _fingerprint
    _pull()                 # what the devices reached so far goes too
    _ring.clear()
    _fingerprint = None


# -- traced stamps (the runtime-path half) -----------------------------------

def trace_stamps_enabled() -> bool:
    """Should the bucketed step stamp leg-boundary cursors?
    ``AUTODIST_FLIGHTREC=legs`` (or ``trace``) forces them on; every other
    mode is off (the JAX package's ``auto`` picks them on TPU backends
    only; on the card each stamp is one kernel launch, so the port keeps
    them opt-in)."""
    if not enabled():
        return False
    from autodist_tpu_torch.const import ENV

    mode = (ENV.AUTODIST_FLIGHTREC.val or "auto").strip().lower()
    return mode in ("legs", "trace")


def traced_stamp(leg: str, *, slot: Any = None, leg_kind: str = "",
                 device: Any = None) -> None:
    """Stamp a leg-boundary cursor from inside the step.  ``leg`` may hold
    a ``{slot}`` placeholder, resolved with ``slot`` (the pipelined
    microbatch index), so per-slot leg ids stay exact.  On a CUDA
    ``device`` the stamp is stream-ordered (``ops/leg_cursor.stamp``: it
    lands when the device gets there); elsewhere it is
    :func:`record_cursor` at once.  Call sites gate on
    :func:`trace_stamps_enabled` when the step is built."""
    s = -1 if slot is None else int(slot)
    if "{slot}" in leg:
        leg = leg.format(slot=s)
    if device is not None and getattr(device, "type", None) == "cuda":
        from autodist_tpu_torch.ops import leg_cursor

        leg_cursor.stamp(device, leg, leg_kind=leg_kind, slot=s,
                         fingerprint=_fingerprint)
        return
    record_cursor(leg, leg_kind=leg_kind, slot=s)


# -- schedule-IR publication -------------------------------------------------

def publish_ir(ir, directory: str) -> Optional[str]:
    """Write the session's schedule IR as ``schedule-<fp>.json`` under
    the run directory (once per fingerprint), so the chief, a separate
    process, can localize hangs against the exact program the workers
    lowered (:func:`load_published_ir` reads it, whichever package wrote
    it).  ``ir`` needs ``fingerprint()`` and ``to_json()``; never
    raises."""
    try:
        if not directory:
            return None
        fp = ir.fingerprint()
        path = os.path.join(directory, f"schedule-{fp}.json")
        if os.path.exists(path):
            return path
        os.makedirs(directory, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(ir.to_json())
        os.replace(tmp, path)
        return path
    except Exception:  # pragma: no cover - advisory
        return None


def load_published_ir(run_dir: str,
                      fingerprint: Optional[str] = None) -> Optional[dict]:
    """The newest published ``schedule-*.json`` under ``run_dir``
    (recursive) as a raw dict, so the CLI can localize."""
    pattern = f"schedule-{fingerprint}.json" if fingerprint \
        else "schedule-*.json"
    paths = glob.glob(os.path.join(run_dir, "**", pattern), recursive=True)
    for path in sorted(paths, key=lambda p: os.path.getmtime(p),
                       reverse=True):
        try:
            with open(path, "r", encoding="utf-8") as f:
                d = json.load(f)
            if isinstance(d, dict) and d.get("legs"):
                return d
        except (OSError, ValueError):
            continue
    return None


# -- hang localization -------------------------------------------------------

class _LegView:
    """Minimal leg adapter (id/deps/kind/stage) over IR legs or raw
    dicts — what the happens-before structures consume; ``stage`` lets
    the hang report name the wedged pipeline stage."""

    __slots__ = ("id", "deps", "kind", "stage")

    def __init__(self, id: str, deps: Tuple[str, ...], kind: str,
                 stage: str = ""):
        self.id = id
        self.deps = deps
        self.kind = kind
        self.stage = stage


def leg_views(legs_or_ir) -> List[_LegView]:
    legs = getattr(legs_or_ir, "legs", None)
    if legs is None and isinstance(legs_or_ir, dict):
        legs = legs_or_ir.get("legs", ())
    if legs is None:
        legs = legs_or_ir
    out = []
    for l in legs:
        if isinstance(l, dict):
            out.append(_LegView(str(l.get("id", "")),
                                tuple(l.get("deps", ()) or ()),
                                str(l.get("kind", "")),
                                str(l.get("stage", "") or "")))
        else:
            out.append(_LegView(l.id, tuple(l.deps), l.kind,
                                str(getattr(l, "stage", "") or "")))
    return out


def _topo(views: Sequence[_LegView]) -> Optional[List[str]]:
    """Deterministic Kahn topological order (deps first); None on a
    cycle.  Unknown dep ids are ignored (a published IR is already
    verifier-clean; tolerance keeps hand-built test fixtures easy)."""
    ids = {v.id for v in views}
    indeg: Dict[str, int] = {v.id: 0 for v in views}
    succs: Dict[str, List[str]] = {v.id: [] for v in views}
    for v in views:
        for dep in v.deps:
            if dep in ids and dep != v.id:
                indeg[v.id] += 1
                succs[dep].append(v.id)
    frontier = [v.id for v in views if indeg[v.id] == 0]
    order: List[str] = []
    while frontier:
        nid = frontier.pop(0)
        order.append(nid)
        for s in succs[nid]:
            indeg[s] -= 1
            if indeg[s] == 0:
                frontier.append(s)
    return order if len(order) == len(views) else None


class _PureReach:
    """Ancestor-set reachability over a topological order: ``reaches(a,
    b)`` is True when leg ``a`` happens before leg ``b`` (the JAX
    package's pure fallback)."""

    def __init__(self, views: Sequence[_LegView], order: Sequence[str]):
        by_id = {v.id: v for v in views}
        self._anc: Dict[str, set] = {}
        for lid in order:
            anc: set = set()
            for dep in by_id[lid].deps:
                if dep in self._anc:
                    anc.add(dep)
                    anc |= self._anc[dep]
            self._anc[lid] = anc

    def reaches(self, a: str, b: str) -> bool:
        return a in self._anc.get(b, ())


def happens_before(legs_or_ir):
    """The happens-before relation over ``legs_or_ir`` (an IR object,
    its dict form, or a bare leg list) as a :class:`_PureReach`.  None
    when the dep graph is cyclic."""
    views = leg_views(legs_or_ir)
    order = _topo(views)
    if order is None:
        return None
    return _PureReach(views, order)


@dataclass
class HangDiagnosis:
    """Where a hang localizes: the frontier leg(s) no one has passed
    and the culprit host(s) that have not entered them."""

    frontier_leg: Optional[str] = None
    frontier_legs: Tuple[str, ...] = ()
    culprits: Tuple[str, ...] = ()
    tie: bool = False
    detail: str = ""
    fingerprint: Optional[str] = None
    per_host: Dict[str, dict] = field(default_factory=dict)
    #: pipeline stage of the frontier leg ("" when the schedule has no
    #: per-stage legs) — names the wedged stage in the MPMD hang report.
    stage: str = ""

    def to_dict(self) -> dict:
        return {"frontier_leg": self.frontier_leg,
                "frontier_legs": list(self.frontier_legs),
                "culprits": list(self.culprits), "tie": self.tie,
                "detail": self.detail, "fingerprint": self.fingerprint,
                "per_host": self.per_host,
                **({"stage": self.stage} if self.stage else {})}

    @classmethod
    def from_dict(cls, d: dict) -> "HangDiagnosis":
        return cls(frontier_leg=d.get("frontier_leg"),
                   frontier_legs=tuple(d.get("frontier_legs", ())),
                   culprits=tuple(d.get("culprits", ())),
                   tie=bool(d.get("tie", False)),
                   detail=str(d.get("detail", "")),
                   fingerprint=d.get("fingerprint"),
                   per_host=dict(d.get("per_host", {})),
                   stage=str(d.get("stage", "") or ""))


def localize_hang(legs_or_ir, cursors: Dict[str, Optional[dict]],
                  fingerprint: Optional[str] = None
                  ) -> Optional[HangDiagnosis]:
    """Diff per-host cursors against the schedule's happens-before
    relation and name the frontier leg and culprit host(s).

    ``cursors`` maps host/worker name → beacon cursor dict (None
    entries tolerated).  Rules, in order:

    1. hosts at DIFFERENT steps: the minimum-step host(s) are the
       culprits — they have not finished a step every peer completed
       (the frontier is their cursor leg when it names one);
    2. same step: among the distinct cursor legs the IR knows, the
       frontier is the happens-before-minimal set; culprits are the
       hosts stuck at a frontier leg.  When NO ordering separates the
       hosts (everyone at one leg, or mutually unordered legs) the
       diagnosis is a ``tie`` — all hosts are equally blocked, which
       points at an external cause (fabric, a peer outside the cursor
       set) rather than one straggler.

    Returns None when no host carries a usable cursor."""
    per_host = {h: dict(c) for h, c in (cursors or {}).items()
                if isinstance(c, dict) and c.get("leg")}
    if not per_host:
        return None
    diag = HangDiagnosis(fingerprint=fingerprint, per_host=per_host)

    def _stamp_stage(d: HangDiagnosis) -> HangDiagnosis:
        """Name the wedged pipeline stage (and call out a transport
        frontier — the cross-slice MPMD wedge) from the frontier leg's
        IR metadata."""
        if d.frontier_leg is None or legs_or_ir is None:
            return d
        for v in leg_views(legs_or_ir):
            if v.id == d.frontier_leg:
                if v.stage:
                    d.stage = v.stage
                    extra = f" — wedged at pipeline stage {v.stage!r}"
                    if v.kind in ("send_act", "recv_act"):
                        extra += (f" on {v.kind} leg {v.id!r} (cross-"
                                  "slice activation transport)")
                    d.detail += extra
                break
        return d

    steps = {h: int(c["step"]) for h, c in per_host.items()
             if c.get("step") is not None}
    if steps and len(set(steps.values())) > 1:
        lo, hi = min(steps.values()), max(steps.values())
        culprits = tuple(sorted(h for h, s in steps.items() if s == lo))
        diag.culprits = culprits
        legs = sorted({per_host[h]["leg"] for h in culprits})
        diag.frontier_legs = tuple(legs)
        diag.frontier_leg = legs[0] if legs else None
        diag.detail = (
            f"host(s) {', '.join(culprits)} still at step {lo} while "
            f"peers reached step {hi}"
            + (f" — last cursor {cursor_line(per_host[culprits[0]])}"
               if culprits else ""))
        return _stamp_stage(diag)

    views = leg_views(legs_or_ir) if legs_or_ir is not None else []
    known_ids = {v.id for v in views}
    known = {h: c["leg"] for h, c in per_host.items()
             if c["leg"] in known_ids}
    if not known:
        hosts = tuple(sorted(per_host))
        diag.culprits = hosts
        diag.tie = len(hosts) > 1
        diag.detail = ("no cursor names a leg of the published schedule "
                       "(host-phase cursors only) — cannot separate hosts "
                       "beyond step parity")
        return diag
    hb = happens_before(views)
    distinct = sorted(set(known.values()))
    if hb is None:
        frontier = distinct
    else:
        frontier = [L for L in distinct
                    if not any(hb.reaches(L2, L)
                               for L2 in distinct if L2 != L)]
    diag.frontier_legs = tuple(frontier)
    diag.frontier_leg = frontier[0] if frontier else None
    culprits = tuple(sorted(h for h, L in known.items() if L in frontier))
    diag.culprits = culprits
    # A tie needs MULTIPLE equally-blocked hosts: one host wedged at a
    # schedule leg while its peers only show host-phase cursors is a
    # unique culprit, not a tie.
    diag.tie = len(known) > 1 and set(culprits) == set(known)
    if diag.tie:
        diag.detail = (
            f"all hosts blocked at frontier leg(s) "
            f"{', '.join(frontier)} — no unique culprit (peer outside "
            "the cursor set, or the fabric itself)")
    else:
        blocked = sorted(set(known.values()) - set(frontier))
        diag.detail = (
            f"host(s) {', '.join(culprits)} never completed frontier "
            f"leg {diag.frontier_leg}, a happens-before dependency of "
            f"the leg(s) every peer is blocked in ({', '.join(blocked)})")
    return _stamp_stage(diag)


# -- crash bundles -----------------------------------------------------------

def find_bundles(run_dir: str) -> List[str]:
    """``bundle-*/`` directories under ``run_dir`` (recursive), oldest
    first."""
    if not run_dir:
        return []
    out = [p for p in glob.glob(os.path.join(
        run_dir, "**", BUNDLE_PREFIX + "*"), recursive=True)
        if os.path.isdir(p)]
    return sorted(out, key=lambda p: (os.path.getmtime(p), p))


def _verdict_dict(h) -> dict:
    """A WorkerHealth (or plain dict) as a JSON-ready verdict row."""
    if isinstance(h, dict):
        return dict(h)
    out = {}
    for k in ("worker", "state", "age", "step", "pid", "detail", "phase",
              "snapshot", "cursor"):
        v = getattr(h, k, None)
        if v is not None:
            out[k] = v
    return out


def dump_bundle(run_dir: str, *, reason: str = "", ir=None,
                verdicts: Optional[Dict[str, Any]] = None,
                tail: int = 200) -> Optional[str]:
    """Snapshot the black box into ``<run_dir>/bundle-<ts>/``.

    Contents (each best-effort — a failing artifact is recorded in the
    MANIFEST, never raised): this process's cursor ring + any
    ``cursors-*.jsonl`` peers already flushed under ``run_dir``, the
    monitor ``verdicts`` (WorkerHealth rows, with their beacon-carried
    cursors), the merged event-journal and StepRecord tails, all-thread
    faulthandler stacks, the schedule IR (the ``ir`` argument or the
    newest published ``schedule-*.json``), and — when the verdict
    cursors localize — a ``hang.json`` diagnosis, also emitted as a
    ``flightrec/hang`` journal event.  Returns the bundle path."""
    if not run_dir:
        return None
    stamp = time.strftime("%Y%m%d-%H%M%S")
    bundle = os.path.join(run_dir, f"{BUNDLE_PREFIX}{stamp}-{os.getpid()}")
    n = 0
    while os.path.exists(bundle):   # same second, same pid: suffix
        n += 1
        bundle = os.path.join(
            run_dir, f"{BUNDLE_PREFIX}{stamp}-{os.getpid()}.{n}")
    try:
        os.makedirs(bundle, exist_ok=True)
    except OSError:
        return None
    files: List[str] = []
    errors: List[str] = []

    def _try(name, fn):
        try:
            out = fn()
            if out:
                files.append(name)
            return out
        except Exception as e:
            errors.append(f"{name}: {e!r}")
            return None

    # 1. cursor rings: this process's, plus every peer ring already
    # flushed under the run dir (each process dumps its own on fatal
    # paths; the chief collects whatever exists).
    _try("cursors", lambda: dump_cursors(bundle))
    for path in glob.glob(os.path.join(run_dir, "**", "cursors-*.jsonl"),
                          recursive=True):
        if os.path.dirname(path).startswith(bundle):
            continue
        name = os.path.basename(path)
        _try(name, lambda p=path, nm=name: shutil.copy2(
            p, os.path.join(bundle, nm)))

    # 2. monitor verdicts (beacon cursors ride each row).
    verdict_rows = {w: _verdict_dict(h) for w, h in (verdicts or {}).items()}
    if verdict_rows:
        def _write_verdicts():
            with open(os.path.join(bundle, "verdicts.json"), "w",
                      encoding="utf-8") as f:
                json.dump(verdict_rows, f, indent=2, default=str)
            return True
        _try("verdicts.json", _write_verdicts)

    # 3. journal + StepRecord tails.
    def _write_events():
        from autodist_tpu_torch.telemetry.events import load_run_events

        evs = load_run_events(run_dir, tail=tail)
        if not evs:
            return False
        with open(os.path.join(bundle, "events_tail.jsonl"), "w",
                  encoding="utf-8") as f:
            for e in evs:
                f.write(json.dumps(e, default=str) + "\n")
        return True
    _try("events_tail.jsonl", _write_events)

    def _write_steps():
        from autodist_tpu_torch.telemetry.timeline import load_step_records

        recs = load_step_records(run_dir)[-max(tail, 0):]
        if not recs:
            return False
        with open(os.path.join(bundle, "steps_tail.jsonl"), "w",
                  encoding="utf-8") as f:
            for r in recs:
                f.write(r.to_json() + "\n")
        return True
    _try("steps_tail.jsonl", _write_steps)

    # 4. all-thread stacks of THIS process (on a wedge, the chief's
    # stacks show the watch loop; each worker's fatal handler dumps its
    # own — see install_fatal_handlers).
    def _write_stacks():
        path = os.path.join(bundle, f"stacks-{_host()}-{os.getpid()}.txt")
        with open(path, "w", encoding="utf-8") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
        return True
    _try("stacks", _write_stacks)

    # 5. schedule IR + fingerprint.
    ir_dict = None

    def _write_ir():
        nonlocal ir_dict
        if ir is not None:
            ir_dict = ir.to_dict() if hasattr(ir, "to_dict") else dict(ir)
        else:
            ir_dict = load_published_ir(run_dir)
        if ir_dict is None:
            return False
        with open(os.path.join(bundle, "schedule_ir.json"), "w",
                  encoding="utf-8") as f:
            json.dump(ir_dict, f, sort_keys=True)
        return True
    _try("schedule_ir.json", _write_ir)

    # 6. hang localization from the beacon-carried cursors.
    diagnosis = None

    def _write_hang():
        nonlocal diagnosis
        cursors = {w: row.get("cursor") for w, row in verdict_rows.items()}
        if not any(cursors.values()):
            return False
        fp = next((c.get("fingerprint") for c in cursors.values()
                   if c and c.get("fingerprint")), None)
        diagnosis = localize_hang(ir_dict, cursors, fingerprint=fp)
        if diagnosis is None:
            return False
        with open(os.path.join(bundle, "hang.json"), "w",
                  encoding="utf-8") as f:
            json.dump(diagnosis.to_dict(), f, indent=2)
        return True
    _try("hang.json", _write_hang)

    manifest = {
        "time": time.time(), "reason": reason, "host": _host(),
        "pid": os.getpid(), "run_dir": run_dir, "files": files,
        "fingerprint": (diagnosis.fingerprint if diagnosis else None)
        or _fingerprint,
        **({"errors": errors} if errors else {}),
        **({"diagnosis": diagnosis.to_dict()} if diagnosis else {}),
    }
    try:
        with open(os.path.join(bundle, "MANIFEST.json"), "w",
                  encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, default=str)
    except OSError:
        pass
    if diagnosis is not None:
        try:
            from autodist_tpu_torch.telemetry.events import emit_event

            emit_event(EVENT_HANG, bundle=bundle, reason=reason,
                       **diagnosis.to_dict())
        except Exception:  # pragma: no cover - defensive
            pass
    return bundle


def read_bundle(bundle_dir: str) -> dict:
    """Parse a bundle back into dicts: manifest, diagnosis, verdicts,
    per-file cursors, events/steps tails (missing pieces omitted)."""
    out: dict = {"path": bundle_dir}
    for name, key in (("MANIFEST.json", "manifest"),
                      ("hang.json", "diagnosis"),
                      ("verdicts.json", "verdicts")):
        try:
            with open(os.path.join(bundle_dir, name), encoding="utf-8") as f:
                out[key] = json.load(f)
        except (OSError, ValueError):
            pass
    cursors: Dict[str, List[dict]] = {}
    for path in sorted(glob.glob(os.path.join(bundle_dir,
                                              "cursors-*.jsonl"))):
        name = os.path.basename(path)[len("cursors-"):-len(".jsonl")]
        cursors[name] = [c.to_dict() for c in load_cursors(path)]
    if cursors:
        out["cursors"] = cursors
    stacks: Dict[str, str] = {}
    for path in sorted(glob.glob(os.path.join(bundle_dir, "stacks-*.txt"))):
        try:
            with open(path, encoding="utf-8") as f:
                stacks[os.path.basename(path)] = f.read()
        except OSError:
            continue
    if stacks:
        out["stacks"] = stacks
    return out


def render_hang_report(bundle_dir: str, stack_lines: int = 12) -> str:
    """The human bundle report (``python -m autodist_tpu_torch.telemetry
    --hang-report <bundle>``): per-host cursor table, frontier leg,
    culprit verdict, stack excerpts."""
    b = read_bundle(bundle_dir)
    man = b.get("manifest") or {}
    lines = [f"flight-recorder bundle: {bundle_dir}"]
    if man:
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(man.get("time", 0)))
        lines.append(f"  reason: {man.get('reason') or 'unspecified'}"
                     f"  (host {man.get('host')}, pid {man.get('pid')},"
                     f" {when})")
        if man.get("fingerprint"):
            lines.append(f"  schedule fingerprint: {man['fingerprint']}")
    verdicts = b.get("verdicts") or {}
    if verdicts:
        lines.append("  per-host cursors:")
        for w in sorted(verdicts):
            row = verdicts[w]
            cur = row.get("cursor")
            doing = cursor_line(cur, float(row.get("age") or 0.0)) \
                if cur else "(no cursor)"
            lines.append(f"    {w:16s} {row.get('state', '?'):8s}"
                         f" step {row.get('step')}  {doing}")
    diag = b.get("diagnosis")
    if diag:
        lines.append(f"  frontier leg: {diag.get('frontier_leg')}"
                     + (f"  (frontier set: "
                        f"{', '.join(diag.get('frontier_legs', []))})"
                        if len(diag.get("frontier_legs", [])) > 1 else ""))
        if diag.get("stage"):
            lines.append(f"  wedged stage: {diag['stage']}")
        verdict = "TIE — no unique culprit" if diag.get("tie") \
            else f"culprit: {', '.join(diag.get('culprits', []))}"
        lines.append(f"  {verdict}")
        lines.append(f"  {diag.get('detail', '')}")
    else:
        lines.append("  no hang diagnosis in this bundle (no leg cursors"
                     " or no schedule IR)")
    for name, text in sorted((b.get("stacks") or {}).items()):
        head = text.strip().splitlines()[:max(stack_lines, 1)]
        lines.append(f"  {name} (first {len(head)} line(s)):")
        lines.extend(f"    {ln}" for ln in head)
    cursors = b.get("cursors") or {}
    for name in sorted(cursors):
        tail = cursors[name][-3:]
        lines.append(f"  ring {name}: {len(cursors[name])} cursor(s),"
                     " last "
                     + "; ".join(cursor_line(c) or c.get("leg", "?")
                                 for c in tail))
    return "\n".join(lines)


# -- fatal-path arming -------------------------------------------------------

_fatal_lock = threading.Lock()
_fatal_armed: Optional[str] = None
_fatal_file = None


def install_fatal_handlers(run_dir: str) -> bool:
    """Arm the fatal paths for this process: faulthandler writes
    all-thread stacks to ``fatal-<host>-<pid>.log`` under ``run_dir``
    on SIGSEGV/SIGABRT/SIGFPE/SIGBUS/SIGILL, and an ``sys.excepthook``
    wrapper dumps a crash bundle (plus this process's cursor ring) on
    any uncaught exception before chaining to the previous hook.
    Idempotent per process; never raises."""
    global _fatal_armed, _fatal_file
    if not run_dir:
        return False
    with _fatal_lock:
        if _fatal_armed is not None:
            return True
        try:
            os.makedirs(run_dir, exist_ok=True)
            path = os.path.join(run_dir,
                                f"fatal-{_host()}-{os.getpid()}.log")
            _fatal_file = open(path, "w", encoding="utf-8")
            faulthandler.enable(file=_fatal_file, all_threads=True)
        except Exception:
            return False
        prev_hook = sys.excepthook

        def _hook(exc_type, exc, tb, _prev=prev_hook, _dir=run_dir):
            try:
                dump_cursors(_dir)
                dump_bundle(_dir,
                            reason=f"uncaught {exc_type.__name__}: {exc}")
            except Exception:
                pass
            _prev(exc_type, exc, tb)

        sys.excepthook = _hook
        _fatal_armed = run_dir
        return True
