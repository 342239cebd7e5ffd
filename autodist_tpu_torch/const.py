"""Constants and the environment registry of the port.

Port of the JAX package's ``const.py``: mesh-axis names, the working
directory for run artifacts (strategies, profiler traces, plan dumps,
logs, telemetry), and a typed registry of the environment variables the
port reads (same names, same parsers, same defaults).
"""
from __future__ import annotations

import enum
import os
import tempfile

# Root for run artifacts (serialized strategies).  The JAX package's
# override variable, under the process's temporary directory by default.
DEFAULT_WORKING_DIR = os.environ.get(
    "AUTODIST_TPU_WORKDIR", os.path.join(tempfile.gettempdir(), "autodist_tpu"))
DEFAULT_STRATEGY_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")
DEFAULT_TRACE_DIR = os.path.join(DEFAULT_WORKING_DIR, "traces")
DEFAULT_GRAPH_DIR = os.path.join(DEFAULT_WORKING_DIR, "graphs")
DEFAULT_LOG_DIR = os.path.join(DEFAULT_WORKING_DIR, "logs")
DEFAULT_TELEMETRY_DIR = os.path.join(DEFAULT_WORKING_DIR, "telemetry")

MESH_AXIS_DATA = "data"      # data parallelism (batch axis)
MESH_AXIS_MODEL = "model"    # tensor/model parallelism
MESH_AXIS_SEQ = "seq"        # sequence/context parallelism
MESH_AXIS_PIPE = "pipe"      # pipeline parallelism
MESH_AXIS_EXPERT = "expert"  # expert parallelism (MoE)


def _bool(v):
    return v in ("True", "true", "1")


def _str(v):
    return v or ""


def _int0(v):
    return int(v) if v else 0


def _int2(v):
    return int(v) if v else 2


def _float0(v):
    return float(v) if v else 0.0


def _loglevel(v):
    return v or "INFO"


def _bool_default_true(v):
    return v not in ("False", "false", "0")


def _proxy_refresh(v):
    """``stale_sync.proxy_refresh_period``'s parser: at least 1."""
    return max(1, int("1" if v is None else v))


def _dcn_wire(v):
    """``schedule_ir.dcn_wire_compressor_default``'s parser: ``int8``
    puts the cross-slice leg on the quantized wire, anything else is the
    full-precision wire."""
    return "Int8Compressor" if (v or "").strip().lower() == "int8" \
        else "NoneCompressor"


class ENV(enum.Enum):
    """``ENV.X.val`` is the parsed value of environment variable ``X``;
    each member's value is ``(name, parser)``."""

    # strategy id to load instead of building (worker path)
    AUTODIST_STRATEGY_ID = ("AUTODIST_STRATEGY_ID", _str)
    # relaxes the one-AutoDist-per-process guard during tests
    AUTODIST_IS_TESTING = ("AUTODIST_IS_TESTING", _bool)
    # the supervisor's failure-marker directory (numerics rollbacks write
    # their marker there; resilience.Supervisor sets it for each attempt)
    AUTODIST_SUPERVISOR_DIR = ("AUTODIST_SUPERVISOR_DIR", _str)
    # watcher behavior on worker death: fail_fast (default) | ignore |
    # restart | supervised (resilience.supervisor.policy_from_env)
    AUTODIST_FAILURE_POLICY = ("AUTODIST_FAILURE_POLICY", _str)
    # deterministic fault-injection spec (resilience.chaos grammar)
    AUTODIST_CHAOS = ("AUTODIST_CHAOS", _str)
    # proxy variables' refresh period in steps (1: always fresh)
    AUTODIST_PROXY_REFRESH = ("AUTODIST_PROXY_REFRESH", _proxy_refresh)
    # the hier cross-slice leg's wire: the compressor it names
    AUTODIST_DCN_WIRE = ("AUTODIST_DCN_WIRE", _dcn_wire)
    AUTODIST_MIN_LOG_LEVEL = ("AUTODIST_MIN_LOG_LEVEL", _loglevel)
    # profiler-trace the first N session steps (0: off)
    AUTODIST_TRACE_STEPS = ("AUTODIST_TRACE_STEPS", _int0)
    # comma-separated steps at which a trace window opens mid-run (each
    # AUTODIST_TRACE_STEPS steps long, at least 1); windows never overlap
    AUTODIST_TRACE_AT = ("AUTODIST_TRACE_AT", _str)
    # telemetry master switch (default on): the metrics registry, the
    # per-step StepRecords and the event journal
    AUTODIST_TELEMETRY = ("AUTODIST_TELEMETRY", _bool_default_true)
    # when set, StepRecords, the event journal and request spans flush as
    # JSONL under this run directory (one writer per process)
    AUTODIST_TELEMETRY_DIR = ("AUTODIST_TELEMETRY_DIR", _str)
    # a calibration.json of fitted cost-model constants (read by the
    # default loader of strategy/cost_model.estimate_ir_cost)
    AUTODIST_CALIBRATION = ("AUTODIST_CALIBRATION", _str)
    # flight recorder: "0" off, "host" (and the default) step and
    # checkpoint phase cursors; "legs" adds a cursor at the schedule IR's
    # leg boundaries inside the step (stream-ordered on the card)
    AUTODIST_FLIGHTREC = ("AUTODIST_FLIGHTREC", _str)
    # implicit program capture inside ad.scope() (the optimizer factories
    # and torch.func's gradient transforms, autodist_tpu_torch/patch.py)
    AUTODIST_PATCH = ("AUTODIST_PATCH", _bool_default_true)
    # preemption grace window in seconds: at a preemption notice, fit
    # compares the last measured persistent-save time against it and
    # sends the emergency state to the peer RAM tier when a durable save
    # cannot finish in time; 0: no deadline (always the persistent save)
    AUTODIST_PREEMPT_GRACE_S = ("AUTODIST_PREEMPT_GRACE_S", _float0)
    # RAM checkpoint tier (checkpoint/tiers.py): snapshot cadence in steps
    # (0: off), ring depth and the peer-mirror directory; fit() arguments
    # override all three
    AUTODIST_SNAPSHOT_EVERY = ("AUTODIST_SNAPSHOT_EVERY", _int0)
    AUTODIST_SNAPSHOT_KEEP = ("AUTODIST_SNAPSHOT_KEEP", _int2)
    AUTODIST_SNAPSHOT_DIR = ("AUTODIST_SNAPSHOT_DIR", _str)
    # buddy host address RAM snapshots mirror to (checkpoint.tiers.buddy_of)
    AUTODIST_BUDDY = ("AUTODIST_BUDDY", _str)
    # which supervisor attempt this process belongs to
    AUTODIST_ATTEMPT = ("AUTODIST_ATTEMPT", _int0)
    # dump the strategy's plan table at session build
    AUTODIST_DUMP_GRAPHS = ("AUTODIST_DUMP_GRAPHS", _bool)
    # pre-flight static strategy analysis (autodist_tpu_torch.analysis)
    # before the session builds: ERROR diagnostics raise
    # StrategyValidationError before any step, WARNs log once.  Also
    # create_distributed_session(validate=...) / fit(validate=...).
    AUTODIST_VALIDATE = ("AUTODIST_VALIDATE", _bool)

    @property
    def val(self):
        """Parsed value of the environment variable, with the typed default."""
        return self.value[1](os.environ.get(self.name))


#: the ROADMAP items that :func:`not_ported` errors name most often.
#: P8 (the schedule IR, the analyzer and its CLI, the cost model, the
#: search, AutoStrategy, the tuner, the simulator, the leg profiler and
#: the leg cursors) is ported whole: nothing raises naming it any more
P8 = ("P8, second half — the self-tuning loop, the what-if simulator, the "
      "analyzer's CLI, the leg profiler and the leg cursors")
#: P9 (telemetry, then resilience: chaos, heartbeats, the Supervisor,
#: elastic resume, the router and the drain) is ported whole: nothing
#: raises naming it any more
P9 = "P9 — telemetry and resilience"
P10 = "P10 — non-data mesh axes"
#: P11 (the rest of serving) is ported whole since its last raise, the
#: SIGTERM drain, came with the router: nothing raises naming it any more
P11 = "P11 — the rest of serving"
P12 = "P12 — runtime, cluster and coordinator"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an unported option raises: it names the ROADMAP item that
    brings it, so nothing runs in place of what was asked."""
    return NotImplementedError(
        f"{what} is not ported to the PyTorch port yet (ROADMAP: {item})")


def unported_function(name: str, what: str, item: str):
    """A function ``name`` that raises :func:`not_ported` for ``what`` when
    called: it imports like the JAX package's function of that name."""
    def stub(*args, **kwargs):
        raise not_ported(what, item)

    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = f"{name}: {item}."
    return stub


def unported_class(name: str, what: str, item: str, bases: tuple = ()):
    """A class ``name`` whose construction raises :func:`not_ported` for
    ``what``: code written for the JAX package fails where it makes one,
    naming the ROADMAP item that brings it, not at its import."""
    def __init__(self, *args, **kwargs):
        raise not_ported(what, item)

    return type(name, bases, {"__init__": __init__,
                              "__doc__": f"{name}: {item}."})
