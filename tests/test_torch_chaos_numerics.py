"""Chaos on the port's numerics and training loop against the JAX
package's (``tests/test_numerics.py``'s chaos drills,
``tests/test_multiprocess_resilience.py``):

* ``nan_grad@bucket=`` and ``inf_grad@var=`` (``AUTODIST_CHAOS``) on the
  bucketed step (``AllReduce(bucket_bytes=...)``, K4's plain version) and
  on ZeRO-1: the skip decision, the health counters, the loss scale and
  the parameters equal the JAX explicit step's under the same injection
  (on its 8 CPU devices); the skipped step leaves the parameters
  bit-identical and the unpoisoned steps equal an uninjected run;
* ``loss_spike`` events through the port's and JAX's ``StepHealthMonitor``
  give the same decisions, and one drives a ``fit`` rollback that ends on
  the uninterrupted run's parameters bit for bit;
* ``fit`` with :class:`ChaosCallback` and :class:`HeartbeatCallback`;
* a supervised relaunch of a 2-rank gloo job under
  ``kill@step=3,proc=1,attempt=0``: the Supervisor sees the exit,
  terminates the survivor, relaunches, and the job resumes from its
  checkpoint to the uninterrupted run's parameters bit for bit (the
  port's twin of ``test_multiprocess_resilience.py``, through
  :class:`Supervisor` since the Coordinator is ROADMAP P12's).

Tolerances: the JAX comparisons at ``test_torch_numerics.TOL`` (1e-5,
float32 and another summation order); skip flags, counters and loss
scales exactly; the port against itself bit for bit.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from autodist_tpu.numerics.policy import NumericsConfig as JNumericsConfig
from autodist_tpu.numerics.policy import StepHealthMonitor as JMonitor
from autodist_tpu_torch.autodist import _reset_default_autodist_for_testing
from autodist_tpu_torch.checkpoint.saver import tree_digest
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.numerics import NumericsConfig, StepHealthMonitor
from autodist_tpu_torch.resilience import (Backoff, ChaosCallback,
                                           ChaosMonkey, HeartbeatCallback,
                                           HeartbeatMonitor, HeartbeatWriter,
                                           Supervisor, SupervisorPolicy,
                                           parse_chaos)

import test_torch_numerics as tn
import torch_launch
import torch_resilience_worker as rworker

pytestmark = [pytest.mark.torch_port, pytest.mark.resilience]

WORKER = Path(__file__).resolve().parent / "torch_resilience_worker.py"
STEPS = 5
POISON = 2          # the device step counter value the injection keys on


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    for k in ("AUTODIST_CHAOS", "AUTODIST_ATTEMPT", "AUTODIST_PROCESS_ID",
              "AUTODIST_SUPERVISOR_DIR"):
        monkeypatch.delenv(k, raising=False)
    _reset_default_autodist_for_testing()
    yield
    _reset_default_autodist_for_testing()


# -- nan_grad / inf_grad on the bucketed step ----------------------------------

def _health(h):
    return (bool(h.all_finite), int(h.skipped_steps), float(h.loss_scale),
            {k: bool(v["finite"]) for k, v in h.per_bucket.items()})


def _run(sess, batches):
    out = []
    for b in batches:
        m = sess.run(b)
        out.append((_health(m["grad_health"]), float(m["loss"])))
    return out


@pytest.mark.parametrize("path", ["bucketed", "zero1"])
@pytest.mark.parametrize("event", ["nan_grad@bucket", "inf_grad@var"])
def test_grad_injection_matches_jax_explicit_step(path, event, monkeypatch):
    jbuild, build, opt = tn.PATHS[path]
    numerics = {"clip_norm": tn.CLIP}
    batches = tn._batches(STEPS)
    clean = tn._port_session(build(), numerics, opt=opt)
    want_clean = _run(clean, batches)
    key = clean._step.buckets[0].key
    spec = (f"nan_grad@step={POISON},bucket={key}"
            if event == "nan_grad@bucket"
            else f"inf_grad@step={POISON},var=l0/w")
    monkeypatch.setenv("AUTODIST_CHAOS", spec)
    sess = tn._port_session(build(), numerics, opt=opt)
    jsess = tn._jax_session(jbuild(), numerics, opt=opt)
    got, ref = [], []
    before = None
    for i, b in enumerate(batches):
        if i == POISON:
            before = {k: v.clone() for k, v in flatten(sess.device_params)}
        m = sess.run(b)
        got.append((_health(m["grad_health"]), float(m["loss"])))
        if i == POISON:
            after = dict(flatten(sess.device_params))
            assert all(torch.equal(after[k], before[k]) for k in before)
        jm = jsess.run(b)
        jh = jm["grad_health"]
        ref.append(((bool(jh.all_finite), int(jh.skipped_steps),
                     float(jh.loss_scale),
                     {k: bool(v["finite"]) for k, v in jh.per_bucket.items()}),
                    float(jm["loss"])))
    flags = [g[0][0] for g in got]
    assert flags == [i != POISON for i in range(STEPS)]
    assert got[POISON][0][1] == 1
    for (h, loss), (jh, jloss) in zip(got, ref):
        assert h == jh
        np.testing.assert_allclose(loss, jloss, rtol=0, atol=tn.TOL)
    # the steps before the poisoned one are the clean run's, bit for bit
    assert got[:POISON] == want_clean[:POISON]
    import jax
    tn._assert_params_close(sess.params, jax.tree.map(np.asarray,
                                                      jsess.params))


def test_injection_without_the_guard_warns_and_trains(monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS", "nan_grad@step=0")
    with pytest.warns(UserWarning, match="numerics guard is off"):
        sess = tn._port_session(tn.PATHS["bucketed"][1](), None)
    m = sess.run(tn._batches(1)[0])
    assert np.isfinite(float(m["loss"]))
    assert all(np.isfinite(v).all() for _, v in flatten(sess.params))


# -- loss spikes ----------------------------------------------------------------

def test_loss_spike_decisions_match_jax(monkeypatch):
    monkeypatch.setenv("AUTODIST_CHAOS",
                       "loss_spike@step=9,factor=1e6;loss_spike@step=12")
    rng = np.random.RandomState(0)
    obs = [(float(1.0 + 0.01 * rng.randn()), True) for _ in range(16)]
    for policy in ("raise", "rollback", "skip"):
        kw = dict(spike_zscore=3.0, spike_window=8, rollback_after=2)
        mine = StepHealthMonitor(NumericsConfig(**kw), policy=policy)
        ref = JMonitor(JNumericsConfig(**kw), policy=policy)
        acts = []
        for step, (loss, finite) in enumerate(obs):
            a = mine.observe(step, loss, finite)
            assert a == ref.observe(step, loss, finite), (policy, step)
            assert mine.bad_streak == ref.bad_streak
            acts.append(a)
        if policy == "rollback":
            assert acts.count("rollback") == 2


def _rollback_session():
    return tn._port_session(tn.PATHS["zero1"][1](), {
        "clip_norm": tn.CLIP, "on_nonfinite": "rollback",
        "spike_zscore": 3.0, "rollback_after": 2}, opt="fusable_adam")


def test_loss_spike_rollback_in_fit_matches_the_oracle(monkeypatch,
                                                       tmp_path):
    batches = tn._batches(2)
    oracle = _rollback_session()
    oracle.fit(batches, epochs=6, steps_per_epoch=2,
               checkpoint_dir=str(tmp_path / "o"))
    monkeypatch.setenv("AUTODIST_CHAOS", "loss_spike@step=9")
    sess = _rollback_session()
    hist = sess.fit(batches, epochs=6, steps_per_epoch=2,
                    checkpoint_dir=str(tmp_path / "c"))
    (rb,) = hist.history["rollbacks"]
    assert (rb["at_step"], rb["restored_step"]) == (9, 8)
    assert sess.step_count == oracle.step_count == 12
    assert tree_digest(sess.params) == tree_digest(oracle.params)


# -- fit with the chaos and heartbeat callbacks ---------------------------------

def test_fit_drives_chaos_and_heartbeat_callbacks(tmp_path):
    sess = tn._port_session(tn.PATHS["zero1"][1](),
                            {"clip_norm": tn.CLIP}, opt="fusable_adam")
    monkey = ChaosMonkey(parse_chaos("kill@step=3;drop_heartbeats@step=5"),
                         process_index=0, attempt=0)
    exits = []
    monkey._exit = exits.append
    writer = HeartbeatWriter(str(tmp_path / "hb"), "w0", interval=30.0,
                             chaos=monkey)
    hist = sess.fit(tn._batches(2), epochs=3, callbacks=[
        ChaosCallback(monkey), HeartbeatCallback(writer)])
    assert hist.steps_run == 6 and exits == [43]
    beacon = json.loads(Path(writer.path).read_text())
    assert beacon["step"] == 4            # beats stopped after step 4
    assert beacon["snapshot"]["step"] == 3   # the recorder's 0-based step
    health = HeartbeatMonitor(str(tmp_path / "hb"), timeout=30.0).check("w0")
    assert health.state == "alive" and health.step == 4


# -- a supervised relaunch of a 2-rank gloo job ---------------------------------

def test_supervised_gloo_relaunch_matches_the_oracle(tmp_path):
    def launch_ranks(directory, out, env):
        init = torch_launch.rendezvous(tmp_path)
        return {f"rank{r}": subprocess.Popen(
            [sys.executable, str(WORKER), str(r), "2", init,
             str(out(r)), "supervised", str(directory)],
            env=torch_launch.rank_env(env), start_new_session=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
            for r in range(2)}

    oracle = launch_ranks(tmp_path / "oracle",
                          lambda r: tmp_path / f"o{r}.npz", {})
    for p in oracle.values():
        assert p.wait(timeout=240) == 0

    ck = tmp_path / "ck"
    outs = []

    def launch(att):
        outs.append(lambda r, i=att.index: tmp_path / f"a{i}_{r}.npz")
        return launch_ranks(ck, outs[-1], dict(
            att.env(), AUTODIST_CHAOS="kill@step=3,proc=1,attempt=0"))

    sup = Supervisor(SupervisorPolicy(
        max_restarts=2, poll_interval=0.1, kill_grace=5.0,
        backoff=Backoff(max_tries=4, base=0.05, cap=0.1, jitter=0)),
        checkpoint_dir=str(ck), workdir=str(tmp_path / "sup"))
    t0 = time.monotonic()
    report = sup.run(launch)
    assert report.ok and report.attempts == 2
    (f,) = report.failures
    assert f.kind == "exit" and f.culprit == "rank1" and "43" in f.detail
    assert time.monotonic() - t0 < 240
    want = np.load(tmp_path / "o0.npz")
    for r in range(2):
        got = np.load(outs[1](r))
        assert int(got["step"]) == int(want["step"]) \
            == 2 * rworker.FIT_EPOCHS
        assert str(got["digest"]) == str(want["digest"])
    assert not os.path.exists(outs[0](0))
