"""The port's ``DistributedSession.fit`` and the numerics host policy
against the JAX package on the CPU.

* twins of every case of ``tests/test_fit.py`` on its linear problem
  (``x @ w + b``, MSE, ``sgd(0.1)``): history, a single batch dict with
  ``log_every``, generator factories, callbacks and ``TimeHistory``,
  checkpoint and resume (to the total epochs), preemption (checkpoint,
  resume, unknown and duplicate signals, handlers restored when a
  callback raises), empty and exhausted epochs, a shared iterator, the
  final checkpoint beyond the stride, validation;
* the JAX ``fit``'s ``history["loss"]`` and ``["epoch_loss"]`` against
  the port's on the same data at rtol 1e-5, and an exact mid-epoch data
  resume through the JAX package's ``DataLoader`` (plain numpy);
* twins of ``tests/test_numerics.py``'s fit policies on its tanh MLP:
  skips counted in the history, ``raise``, the guard required, rollback
  to the last verified-good step matching an uninterrupted oracle (a
  poisoned batch, a NaN streak or a spiking one, stands in for the chaos
  harness's injected spike), the failure marker in the supervisor's
  format, an exhausted rollback budget; ``StepHealthMonitor`` against
  the JAX one on the same observations;
* the options that raised naming their ROADMAP item until P8's second
  half (``tuner``, ``tiers``, ``snapshot_every``, ``snapshot_keep``,
  ``snapshot_dir``) now train (``tests/test_torch_tiers.py`` and
  ``tests/test_torch_tuner.py`` hold them to the JAX package).
"""
import os
import signal

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.numerics.policy import NumericsConfig as JNumericsConfig
from autodist_tpu.numerics.policy import \
    StepHealthMonitor as JStepHealthMonitor
from autodist_tpu.resilience.supervisor import read_failure_markers
from autodist_tpu.runtime.data_loader import DataLoader
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.tiers import CheckpointTiers
from autodist_tpu_torch.const import P8
from autodist_tpu_torch.fit import Callback, History, TimeHistory
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.numerics import (NUMERICS_MARKER_CODE,
                                         NonFiniteError, NumericsConfig,
                                         StepHealthMonitor)
from autodist_tpu_torch.strategy import AllReduce, PartitionedPS

pytestmark = pytest.mark.torch_port

W_TRUE = np.array([[1.0], [-2.0], [0.5]], np.float32)


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(16, 3).astype(np.float32)
        out.append({"x": x, "y": (x @ W_TRUE).astype(np.float32)})
    return out


def _loss_fn(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    return ((pred - batch["y"]) ** 2).mean()


def _make_session(builder=None):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder or AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params={"w": torch.zeros(3, 1), "b": torch.zeros(1)},
                   optimizer=optim.sgd(0.1), loss_fn=_loss_fn)
    return ad.create_distributed_session()


def _jax_session():
    jax_reset()
    ad = JAutoDist(strategy_builder=JAllReduce())
    with ad.scope():
        ad.capture(params={"w": jnp.zeros((3, 1)), "b": jnp.zeros((1,))},
                   optimizer=optax.sgd(0.1),
                   loss_fn=lambda p, b: jnp.mean(
                       (b["x"] @ p["w"] + p["b"] - b["y"]) ** 2))
    return ad.create_distributed_session()


def test_fit_trains_and_records_history():
    sess = _make_session()
    data = _batches(8)
    first = float(sess.run(data[0])["loss"])

    hist = sess.fit(data, epochs=3)
    assert isinstance(hist, History)
    assert hist.epochs_run == 3
    assert hist.steps_run == 24
    assert len(hist.history["epoch_loss"]) == 3
    assert hist.history["epoch_loss"][-1] < first
    assert hist.history["epoch_loss"][2] < hist.history["epoch_loss"][0]
    # the JAX fit's goodput summary (telemetry is on by default)
    assert set(hist.goodput) == {"wall_s", "useful_step_s",
                                 "checkpoint_stall_s", "rollback_s",
                                 "steps", "goodput_ratio"}
    assert hist.goodput["steps"] == 24
    assert 0.0 < hist.goodput["goodput_ratio"] <= 1.0
    assert hist.resume_tier is None


def test_fit_single_batch_dict_and_log_every():
    sess = _make_session()
    hist = sess.fit(_batches(1)[0], epochs=1, steps_per_epoch=10,
                    log_every=3)
    assert hist.steps_run == 10
    # log_every=3 sampled at steps 3, 6, 9 plus the epoch-end sample
    assert len(hist.history["loss"]) == 4
    assert hist.history["loss"][-1] <= hist.history["loss"][0]


def test_fit_generator_factory_fresh_per_epoch():
    sess = _make_session()
    data = _batches(4)
    calls = []

    def factory():
        calls.append(1)
        return iter(data)

    hist = sess.fit(factory, epochs=2)
    assert len(calls) == 2
    assert hist.steps_run == 8


def test_fit_callbacks_and_time_history():
    sess = _make_session()
    events = []

    class Recorder(Callback):
        def on_train_begin(self, session):
            events.append("train_begin")

        def on_epoch_begin(self, epoch):
            events.append(f"epoch_begin:{epoch}")

        def on_step_end(self, step, metrics):
            assert isinstance(metrics["loss"], torch.Tensor)
            events.append("step")

        def on_epoch_end(self, epoch, logs):
            events.append(f"epoch_end:{epoch}:{sorted(logs)}")

        def on_train_end(self, history):
            events.append("train_end")

    th = TimeHistory(items_per_step=16)
    sess.fit(_batches(3), epochs=2, callbacks=[Recorder(), th])
    assert events[0] == "train_begin"
    assert events[-1] == "train_end"
    assert events.count("step") == 6
    assert "epoch_end:1:['epoch_steps', 'loss', 'step']" in events
    assert len(th.epoch_times) == 2
    assert len(th.items_per_sec) == 2
    assert th.items_per_sec[0] > 0


def test_fit_checkpoint_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    sess = _make_session(PartitionedPS())
    data = _batches(5)
    sess.fit(data, epochs=2, checkpoint_dir=ckpt)
    assert sess.step_count == 10
    trained_w = sess.params["w"]

    # a fresh session resumes (params, optimizer state, step counter)
    sess2 = _make_session(PartitionedPS())
    hist = sess2.fit(data, epochs=1, checkpoint_dir=ckpt, resume=True)
    assert sess2.step_count == 15
    assert hist.steps_run == 5
    assert hist.resume_tier == "persistent"

    # resume=False starts from scratch
    sess3 = _make_session(PartitionedPS())
    sess3.fit(data, epochs=1, checkpoint_dir=str(tmp_path / "other"),
              resume=False)
    assert sess3.step_count == 5
    np.testing.assert_array_less(np.abs(trained_w - W_TRUE),
                                 np.abs(sess3.params["w"] - W_TRUE) + 1e-9)


def test_fit_resume_trains_to_total_epochs(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    sess = _make_session(PartitionedPS())
    data = _batches(5)
    sess.fit(data, epochs=2, steps_per_epoch=5, checkpoint_dir=ckpt)
    assert sess.step_count == 10

    sess2 = _make_session(PartitionedPS())
    hist = sess2.fit(data, epochs=4, steps_per_epoch=5,
                     checkpoint_dir=ckpt, resume=True)
    assert sess2.step_count == 20          # epochs 2, 3 only
    assert hist.epochs_run == 2

    # target already met: restores and trains nothing
    sess3 = _make_session(PartitionedPS())
    hist3 = sess3.fit(data, epochs=2, steps_per_epoch=5,
                      checkpoint_dir=ckpt, resume=True)
    assert sess3.step_count == 20 and hist3.steps_run == 0

    # an explicit initial_epoch overrides the derivation
    sess4 = _make_session(PartitionedPS())
    hist4 = sess4.fit(data, epochs=5, steps_per_epoch=5,
                      checkpoint_dir=ckpt, resume=True, initial_epoch=4)
    assert hist4.epochs_run == 1 and sess4.step_count == 25


class _Bomb(Callback):
    """Sends ``signum`` to this process once, at step ``at``."""

    def __init__(self, at, signum=signal.SIGUSR1):
        self.at, self.signum, self.fired_at = at, signum, None

    def on_step_end(self, step, metrics):
        if step == self.at and self.fired_at is None:
            self.fired_at = step
            os.kill(os.getpid(), self.signum)


def test_fit_preemption_checkpoint_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    sess = _make_session()
    data = _batches(6)
    prev = signal.getsignal(signal.SIGUSR1)
    bomb = _Bomb(3)
    hist = sess.fit(data, epochs=4, checkpoint_dir=ckpt, callbacks=[bomb],
                    preemption_signals=("SIGUSR1",))
    assert bomb.fired_at == 3
    assert hist.preempted and hist.preempt_tier == "persistent"
    assert hist.steps_run == 3
    assert hist.epochs_run == 0
    assert signal.getsignal(signal.SIGUSR1) is prev
    assert Saver.latest_step(ckpt) == 3

    sess2 = _make_session()
    hist2 = sess2.fit(data, epochs=1, steps_per_epoch=6,
                      checkpoint_dir=ckpt, resume=True)
    assert not hist2.preempted
    assert sess2.step_count == 9        # resumed at 3, re-ran epoch 0


def test_fit_preemption_rejects_unknown_signal():
    sess = _make_session()
    prev = signal.getsignal(signal.SIGUSR2)
    with pytest.raises(ValueError, match="unknown signal"):
        sess.fit(_batches(2), epochs=1,
                 preemption_signals=("SIGUSR2", "SIGNOPE"))
    assert signal.getsignal(signal.SIGUSR2) is prev


def test_fit_preemption_duplicate_signals_restore_cleanly():
    sess = _make_session()
    prev = signal.getsignal(signal.SIGUSR1)
    hist = sess.fit(_batches(2), epochs=1,
                    preemption_signals=("SIGUSR1", signal.SIGUSR1,
                                        int(signal.SIGUSR1)))
    assert not hist.preempted
    assert signal.getsignal(signal.SIGUSR1) is prev


def test_fit_preemption_handler_restored_when_callback_raises():
    sess = _make_session()

    class Boom(Callback):
        def on_epoch_begin(self, epoch):
            raise RuntimeError("user callback bug")

    prev = signal.getsignal(signal.SIGUSR1)
    with pytest.raises(RuntimeError, match="user callback bug"):
        sess.fit(_batches(2), epochs=1, callbacks=[Boom()],
                 preemption_signals=("SIGUSR1",))
    assert signal.getsignal(signal.SIGUSR1) is prev


def test_fit_empty_epoch_warns_not_crashes():
    sess = _make_session()
    ends = []

    class Ends(Callback):
        def on_epoch_end(self, epoch, logs):
            ends.append(logs["loss"])

    hist = sess.fit([], epochs=2, callbacks=[Ends()])
    assert hist.epochs_run == 2
    assert hist.steps_run == 0
    assert hist.history["epoch_loss"] == []
    assert ends == [None, None]


def test_fit_shared_iterator_chunks_without_dropping_batches():
    sess = _make_session()
    data = _batches(6)
    seen = []
    orig_run = sess.run

    def spy_run(batch, sync=True):
        seen.append(float(batch["x"][0, 0]))
        return orig_run(batch, sync=sync)

    sess.run = spy_run
    hist = sess.fit(iter(data), epochs=3, steps_per_epoch=2,
                    prefetch_depth=2)
    assert hist.steps_run == 6
    assert hist.epochs_run == 3
    assert seen == [float(b["x"][0, 0]) for b in data]


def test_fit_exhausted_iterator_stops_cleanly():
    sess = _make_session()
    hist = sess.fit(iter(_batches(4)), epochs=3)
    assert hist.steps_run == 4
    assert hist.epochs_run == 1
    assert len(hist.history["epoch_loss"]) == 1


def test_fit_log_every_no_duplicate_epoch_sample():
    sess = _make_session()
    hist = sess.fit(_batches(1)[0], epochs=1, steps_per_epoch=9,
                    log_every=3)
    assert hist.history["loss_step"] == [3, 6, 9]
    assert hist.history["epoch_loss"] == [hist.history["loss"][-1]]


def test_fit_final_checkpoint_beyond_stride(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    sess = _make_session()
    sess.fit(_batches(2), epochs=3, checkpoint_dir=ckpt, checkpoint_every=2)
    assert Saver.latest_step(ckpt) == 6  # not 4


def test_fit_requires_steps_for_batch_dict():
    sess = _make_session()
    with pytest.raises(ValueError, match="steps_per_epoch"):
        sess.fit(_batches(1)[0], epochs=1)


def test_evaluate_no_state_change_and_matches():
    sess = _make_session()
    data = _batches(3)
    sess.fit(data, epochs=1)
    w_before = sess.params["w"].copy()
    e1 = float(sess.evaluate(data[0])["loss"])
    e2 = float(sess.evaluate(data[0])["loss"])
    assert e1 == e2
    np.testing.assert_array_equal(sess.params["w"], w_before)
    assert sess.step_count == 3
    singles = [float(sess.evaluate(b)["loss"]) for b in data]
    np.testing.assert_allclose(float(sess.evaluate(data)["loss"]),
                               np.mean(singles), rtol=1e-6)


def test_fit_validation_data():
    sess = _make_session()
    train, val = _batches(4), _batches(2, seed=1)
    logs_seen = []

    class Val(Callback):
        def on_epoch_end(self, epoch, logs):
            logs_seen.append(logs.get("val_loss"))

    hist = sess.fit(train, epochs=3, validation_data=val, callbacks=[Val()])
    assert len(hist.history["val_loss"]) == 3
    assert logs_seen == hist.history["val_loss"]
    assert hist.history["val_loss"][-1] < hist.history["val_loss"][0]


def test_fit_validation_dict_requires_steps_up_front():
    sess = _make_session()
    with pytest.raises(ValueError, match="validation_steps"):
        sess.fit(_batches(2), epochs=2, validation_data=_batches(1)[0])


def test_fit_validation_exhausted_generator_warns_not_crashes():
    sess = _make_session()
    hist = sess.fit(_batches(2), epochs=3,
                    validation_data=iter(_batches(2, seed=1)))
    assert len(hist.history.get("val_loss", [])) == 1
    assert hist.epochs_run == 3


# -- against the JAX package's fit --------------------------------------------

@pytest.mark.parametrize("form", ["list", "dict_log_every", "factory",
                                  "validation"])
def test_fit_history_matches_jax_fit(form):
    """The same data through the JAX ``fit`` and the port's: the loss
    samples, their steps and the epoch losses (and the validation losses)
    at rtol 1e-5."""
    data = _batches(4)
    kwargs = {"list": dict(data=data, epochs=3),
              "dict_log_every": dict(data=data[0], epochs=2,
                                     steps_per_epoch=5, log_every=2),
              "factory": dict(data=lambda: iter(data), epochs=2),
              "validation": dict(data=data, epochs=2,
                                 validation_data=_batches(2, seed=1))}[form]
    want = _jax_session().fit(**kwargs).history
    got = _make_session().fit(**kwargs).history
    assert got.keys() == want.keys()
    assert got["loss_step"] == want["loss_step"]
    for key in ("loss", "epoch_loss", "val_loss"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)


def _loader():
    x = np.random.RandomState(3).randn(96, 3).astype(np.float32)
    return DataLoader({"x": x, "y": (x @ W_TRUE).astype(np.float32)},
                      batch_size=16, shuffle=True, seed=5)


def test_exact_data_resume_with_a_stateful_loader(tmp_path):
    """A loader with ``state()``/``load_state()`` (the JAX package's
    ``DataLoader``, plain numpy): a preemption mid-epoch records the
    position in the meta, and the resumed fit continues at the exact next
    batch, ending on the uninterrupted run's parameters and the JAX fit's
    losses."""
    ckpt = str(tmp_path / "ckpt")
    ref = _make_session()
    ref_hist = ref.fit(_loader(), epochs=2)
    jax_hist = _jax_session().fit(_loader(), epochs=2)
    np.testing.assert_allclose(ref_hist.history["epoch_loss"],
                               jax_hist.history["epoch_loss"], rtol=1e-5)

    sess = _make_session()
    hist = sess.fit(_loader(), epochs=2, checkpoint_dir=ckpt,
                    callbacks=[_Bomb(4)], preemption_signals=("SIGUSR1",))
    assert hist.preempted and sess.step_count == 4
    meta = Saver.read_meta(Saver.latest_checkpoint(ckpt))
    assert meta["data_state"] == {"epoch": 0, "offset": 4, "seed": 5}

    sess2 = _make_session()
    hist2 = sess2.fit(_loader(), epochs=2, checkpoint_dir=ckpt)
    assert sess2.step_count == 12 and hist2.steps_run == 8
    for name in ("w", "b"):
        np.testing.assert_array_equal(sess2.params[name], ref.params[name])


# -- the numerics host policy --------------------------------------------------

def _mlp_params():
    rng = np.random.RandomState(0)
    return {"l0": {"w": torch.tensor(rng.randn(16, 16) * 0.1,
                                     dtype=torch.float32),
                   "b": torch.zeros(16)},
            "l1": {"w": torch.tensor(rng.randn(16, 4) * 0.1,
                                     dtype=torch.float32)}}


def _mlp_batches(n=4, rows=32):
    rng = np.random.RandomState(7)
    return [{"x": rng.randn(rows, 16).astype(np.float32),
             "y": rng.randn(rows, 4).astype(np.float32)} for _ in range(n)]


def _mlp_loss(p, b):
    h = torch.tanh(b["x"] @ p["l0"]["w"] + p["l0"]["b"])
    return ((h @ p["l1"]["w"] - b["y"]) ** 2).mean()


def _fit_session(numerics):
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=AllReduce(bucket_bytes=1 << 20),
                  device="cpu")
    with ad.scope():
        ad.capture(params=_mlp_params(), optimizer=optim.adam(1e-2),
                   loss_fn=_mlp_loss, numerics=numerics)
    return ad.create_distributed_session()


def _poisoned(batch, kind):
    """A NaN batch (non-finite gradients, skipped by the guard) or one
    whose targets are scaled up (a finite loss spike)."""
    if kind == "nan":
        return dict(batch, x=np.full_like(batch["x"], np.nan))
    return dict(batch, y=batch["y"] * 1e4)


def _poison_once(batches, epoch, steps, kind):
    """A generator factory over ``batches`` whose first pass of ``epoch``
    poisons the batches at ``steps``; every later pass is clean (the
    replay after a rollback)."""
    calls = []

    def factory():
        calls.append(1)
        first = len(calls) == epoch + 1
        return iter([_poisoned(b, kind) if first and i in steps else b
                     for i, b in enumerate(batches)])
    return factory


def _always_poison(batches, step_in_epoch, epoch, kind):
    calls = []

    def factory():
        calls.append(1)
        return iter([_poisoned(b, kind)
                     if len(calls) > epoch and i == step_in_epoch else b
                     for i, b in enumerate(batches)])
    return factory


def test_fit_skip_counts_in_history():
    batches = _mlp_batches()
    sess = _fit_session(True)
    hist = sess.fit(_poison_once(batches, 0, {2}, "nan"), epochs=2,
                    steps_per_epoch=4)
    assert hist.history["skipped_steps"] == [1, 1]
    assert hist.steps_run == 8


def test_fit_on_nonfinite_raise():
    sess = _fit_session(True)
    with pytest.raises(NonFiniteError, match="step 3"):
        sess.fit(_poison_once(_mlp_batches(), 0, {2}, "nan"), epochs=2,
                 steps_per_epoch=4, on_nonfinite="raise")


def test_fit_on_nonfinite_requires_guard():
    sess = _fit_session(None)
    with pytest.raises(ValueError, match="numerics"):
        sess.fit(_mlp_batches(2), epochs=1, on_nonfinite="raise")


def test_fit_rollback_requires_checkpoint_dir():
    sess = _fit_session({"on_nonfinite": "rollback"})
    with pytest.raises(ValueError, match="checkpoint_dir"):
        sess.fit(_mlp_batches(2), epochs=1)


@pytest.mark.parametrize("kind,numerics,steps,reason", [
    ("spike", {"spike_zscore": 3.0, "spike_window": 8}, {2}, "loss spike"),
    ("nan", {"rollback_after": 2}, {1, 2}, "2 consecutive non-finite steps"),
])
def test_rollback_matches_uninterrupted_oracle(tmp_path, monkeypatch, kind,
                                               numerics, steps, reason):
    """A poisoned stretch of epoch 2 (a spiking batch, or two NaN batches
    in a row) trips the monitor mid-epoch; fit restores the verified-good
    step 8, replays epoch 2 clean, and ends on the uninterrupted oracle's
    parameters to the bit; the supervisor's marker names the reason."""
    batches = _mlp_batches(4)
    numerics = dict(numerics, on_nonfinite="rollback")
    sess = _fit_session(numerics)
    oracle_hist = sess.fit(batches, epochs=4, steps_per_epoch=4,
                           checkpoint_dir=str(tmp_path / "oracle"))
    oracle = sess.params
    assert "rollbacks" not in oracle_hist.history
    assert Saver.good_steps(str(tmp_path / "oracle")) == [4, 8, 12, 16]

    marker_dir = str(tmp_path / "markers")
    monkeypatch.setenv("AUTODIST_SUPERVISOR_DIR", marker_dir)
    sess = _fit_session(numerics)
    hist = sess.fit(_poison_once(batches, 2, steps, kind), epochs=4,
                    steps_per_epoch=4, checkpoint_dir=str(tmp_path / "drill"))
    at = 8 + max(steps) + 1
    assert hist.history["rollbacks"] == [
        {"at_step": at, "restored_step": 8, "reason": reason}]
    assert sess.step_count == 16
    markers = read_failure_markers(marker_dir)
    assert len(markers) == 1
    assert reason in markers[0]["reason"]
    assert markers[0]["code"] == NUMERICS_MARKER_CODE == 74
    got = dict(flatten(sess.params))
    for name, want in flatten(oracle):
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_rollback_budget_exhaustion_raises(tmp_path):
    """A poisoned batch on every replay: each rollback replays into it
    again until the budget (max_rollbacks=2) is spent."""
    numerics = {"on_nonfinite": "rollback", "spike_zscore": 3.0,
                "spike_window": 8, "max_rollbacks": 2}
    sess = _fit_session(numerics)
    with pytest.raises(NonFiniteError, match="budget"):
        sess.fit(_always_poison(_mlp_batches(4), 2, 2, "spike"), epochs=4,
                 steps_per_epoch=4, checkpoint_dir=str(tmp_path / "ck"))


def test_step_health_monitor_matches_jax():
    """The same observations through the JAX monitor (no chaos events)
    and the port's give the same actions and streaks, resets included."""
    rng = np.random.RandomState(0)
    obs = [(float(1.0 + 0.01 * rng.randn()), True) for _ in range(10)]
    obs += [(50.0, True), (1.0, False), (float("nan"), False), (1.0, True),
            (float("inf"), True), (1.0, False), (1.0, False), (1.0, False)]
    for policy in ("raise", "rollback", "skip"):
        kw = dict(spike_zscore=3.0, spike_window=8, rollback_after=2)
        mine = StepHealthMonitor(NumericsConfig(**kw), policy=policy)
        ref = JStepHealthMonitor(JNumericsConfig(**kw), policy=policy)
        for step, (loss, finite) in enumerate(obs):
            assert mine.observe(step, loss, finite) \
                == ref.observe(step, loss, finite), (policy, step)
            assert mine.bad_streak == ref.bad_streak
            if step == 14:
                mine.reset()
                ref.reset()


_UNPORTED_FIT = [
    (lambda tmp: dict(tuner=_tuner()), P8),
    (lambda tmp: dict(tiers=CheckpointTiers(snapshot_every=1)),
     "P9 — telemetry and resilience"),
    (lambda tmp: dict(snapshot_every=2), "P9 — telemetry and resilience"),
    (lambda tmp: dict(snapshot_keep=2), "P9 — telemetry and resilience"),
    (lambda tmp: dict(snapshot_dir=str(tmp / "snapshots")),
     "P9 — telemetry and resilience"),
]


def _tuner():
    from autodist_tpu_torch.autodist import get_default_autodist
    from autodist_tpu_torch.strategy import ScheduleTuner

    ad = get_default_autodist()
    return ScheduleTuner(ad.graph_item, ad.resource_spec, interval=1,
                         profile=False, calibration_path=None)


# the ids the cases have had since ``validate=True`` (option0) was ported;
# each option raised naming its ROADMAP item until P8's second half
# brought the tuner and the checkpoint tiers: each now trains
@pytest.mark.parametrize("option,item", _UNPORTED_FIT, ids=[
    f"option{i + 1}-{item}" for i, (_, item) in enumerate(_UNPORTED_FIT)])
def test_unported_fit_options_raise_naming_their_item(option, item,
                                                      tmp_path):
    sess = _make_session()
    hist = sess.fit(_batches(2), epochs=1, **option(tmp_path))
    assert hist.steps_run == 2 and sess.step_count == 2
    assert np.isfinite(hist.history["epoch_loss"][-1])
