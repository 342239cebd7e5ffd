"""autodist_tpu_torch.resilience — supervised recovery for training and
serving.

Port of the JAX package's ``resilience`` package, module for module:

* :mod:`~autodist_tpu_torch.resilience.supervisor` — failure policies and
  the job-level :class:`Supervisor` restart loop (backoff and a retry
  budget, elastic host fall-through);
* :mod:`~autodist_tpu_torch.resilience.elastic` — restore a ZeRO-1
  checkpoint across a data-axis resize, exactly;
* :mod:`~autodist_tpu_torch.resilience.heartbeat` — liveness beacons and
  the watchdog that tells "process exited" from "wedged in a step";
* :mod:`~autodist_tpu_torch.resilience.chaos` — deterministic fault
  injection driving the recovery drills;
* :mod:`~autodist_tpu_torch.resilience.backoff` — the shared retry
  schedule.

Imports are lazy (PEP 562), as in the JAX package: a supervisor process
that only launches and watches attempts never imports torch's CUDA
runtime through this package.
"""
from __future__ import annotations

_EXPORTS = {
    "Backoff": "autodist_tpu_torch.resilience.backoff",
    "HeartbeatCallback": "autodist_tpu_torch.resilience.heartbeat",
    "HeartbeatMonitor": "autodist_tpu_torch.resilience.heartbeat",
    "HeartbeatWriter": "autodist_tpu_torch.resilience.heartbeat",
    "heartbeat_phase": "autodist_tpu_torch.resilience.heartbeat",
    "set_active_writer": "autodist_tpu_torch.resilience.heartbeat",
    "PREEMPTED_EXIT_CODE": "autodist_tpu_torch.resilience.supervisor",
    "SUPERVISED_ABORT_CODE": "autodist_tpu_torch.resilience.supervisor",
    "ChaosCallback": "autodist_tpu_torch.resilience.chaos",
    "ChaosMonkey": "autodist_tpu_torch.resilience.chaos",
    "corrupt_checkpoint": "autodist_tpu_torch.resilience.chaos",
    "grad_injections": "autodist_tpu_torch.resilience.chaos",
    "loss_spike_events": "autodist_tpu_torch.resilience.chaos",
    "parse_chaos": "autodist_tpu_torch.resilience.chaos",
    "ServingChaos": "autodist_tpu_torch.resilience.chaos",
    "Attempt": "autodist_tpu_torch.resilience.supervisor",
    "FailFast": "autodist_tpu_torch.resilience.supervisor",
    "FailurePolicy": "autodist_tpu_torch.resilience.supervisor",
    "Ignore": "autodist_tpu_torch.resilience.supervisor",
    "NotifySupervisor": "autodist_tpu_torch.resilience.supervisor",
    "RestartWorker": "autodist_tpu_torch.resilience.supervisor",
    "Supervisor": "autodist_tpu_torch.resilience.supervisor",
    "SupervisorPolicy": "autodist_tpu_torch.resilience.supervisor",
    "SupervisorReport": "autodist_tpu_torch.resilience.supervisor",
    "policy_from_env": "autodist_tpu_torch.resilience.supervisor",
    "ElasticResumeError": "autodist_tpu_torch.resilience.elastic",
    "elastic_restore": "autodist_tpu_torch.resilience.elastic",
    "preflight_elastic": "autodist_tpu_torch.resilience.elastic",
    "remap_data_state": "autodist_tpu_torch.resilience.elastic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'autodist_tpu_torch.resilience' has no attribute "
            f"{name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
