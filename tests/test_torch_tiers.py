"""The port's checkpoint tiers (``autodist_tpu_torch/checkpoint/tiers.py``)
against the JAX package's (``tests/test_recovery_tiers.py:66-325``, all
but the supervisor, heartbeat and chaos tests: those pieces are P9's).

* the RAM ring keeps the last k and drops a tampered snapshot; the peer
  wire format round-trips and refuses a truncated blob; the peer mirror
  keeps the last k, skips a corrupt blob and finds any owner's newest;
  the content digest of a snapshot equals the JAX package's
  ``_tree_digest`` of the same leaves;
* restore routing takes the newest step across RAM, peer and persistent
  tiers (RAM before peer on a tie) and falls through a missing tier;
* ``fit(snapshot_every=...)`` fills the tiers and a fresh process resumes
  from the peer tier alone to the uninterrupted run's parameters;
* the deadline-aware preemption decision: no grace window takes the
  persistent tier, a grace window shorter than the last measured save
  takes the peer tier, and the resume routes through it;
* a snapshot restores through the Saver's logical-to-session import:
  ZeRO-1 shards as ``Saver.restore`` gives them, the stale and proxy
  state, bit-exact continuations; a snapshot of another mesh refuses;
  ``PeerMirror(cluster=)`` names P12.
"""
import os
import signal

import numpy as np
import pytest
import torch

from autodist_tpu.checkpoint.saver import _tree_digest as jax_tree_digest
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.tiers import (CheckpointTiers, PeerMirror,
                                                 RamSnapshot, SnapshotError,
                                                 SnapshotRing, _tree_digest,
                                                 buddy_of, capture_snapshot,
                                                 load_snapshot, route_restore,
                                                 snapshot_from_bytes,
                                                 snapshot_to_bytes)
from autodist_tpu_torch.fit import Callback
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.strategy import AllReduce, PS
from autodist_tpu_torch.telemetry import events as ev

import torch_dp_worker as worker

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    monkeypatch.delenv("AUTODIST_PREEMPT_GRACE_S", raising=False)
    monkeypatch.delenv("AUTODIST_SNAPSHOT_EVERY", raising=False)
    _reset_default_autodist_for_testing()
    yield
    _reset_default_autodist_for_testing()


def _linear_session(lr=1e-2):
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)
    params = {"linear": {"w": torch.zeros(8, 4), "b": torch.zeros(4)}}

    def loss_fn(p, b):
        pred = b["x"] @ p["linear"]["w"] + p["linear"]["b"]
        return torch.mean((pred - b["y"]) ** 2)

    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(lr), loss_fn=loss_fn)
    return ad.create_distributed_session(), \
        {"x": x, "y": (x @ w).astype(np.float32)}


def _snap(step, value, shape=(4,)):
    leaves = {"params": [np.full(shape, value, np.float32)],
              "opt_state": [np.zeros((2,), np.float32)]}
    return RamSnapshot(step=step, leaves=leaves,
                       digest=_tree_digest(leaves))


# -- the RAM ring and the digest rule ----------------------------------------

def test_snapshot_ring_keeps_last_k_and_drops_tampered():
    ring = SnapshotRing(keep=2)
    for s in (2, 4, 6):
        ring.add(_snap(s, float(s)))
    assert ring.steps() == [4, 6]
    assert ring.latest().step == 6
    assert ring.nbytes > 0
    ring.get(6).leaves["params"][0][0] = 999.0
    assert ring.latest().step == 4
    assert ring.steps() == [4]
    with pytest.raises(ValueError):
        SnapshotRing(keep=0)


def test_snapshot_digest_equals_the_jax_package():
    leaves = {"params": [np.arange(12, dtype=np.float32).reshape(3, 4),
                         np.ones((2,), np.int32)],
              "opt_state": [np.zeros((5,), np.float32)]}
    assert _tree_digest(leaves) == jax_tree_digest(
        [leaves[k] for k in sorted(leaves)])


def test_snapshot_serialization_roundtrip_and_corruption():
    leaves = {"params": [np.arange(12, dtype=np.float32).reshape(3, 4),
                         np.ones((2,), np.int32)],
              "opt_state": [np.zeros((5,), np.float32)]}
    snap = RamSnapshot(step=7, leaves=leaves, digest=_tree_digest(leaves),
                       meta={"mesh_axes": {"data": 1},
                             "data_state": {"epoch": 1, "offset": 3}})
    blob = snapshot_to_bytes(snap)
    back = snapshot_from_bytes(blob)
    assert back.step == 7 and back.verify()
    assert back.meta["data_state"] == {"epoch": 1, "offset": 3}
    for item in leaves:
        for a, b in zip(leaves[item], back.leaves[item]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(SnapshotError):
        snapshot_from_bytes(blob[: len(blob) // 2])


def test_peer_mirror_push_fetch_retention_and_digest(tmp_path):
    assert buddy_of(["a", "b", "c"], "a") == "b"
    assert buddy_of(["a", "b", "c"], "c") == "a"
    assert buddy_of(["a"], "a") is None
    assert buddy_of(["a", "b"], "zz") is None
    mirror = PeerMirror(str(tmp_path / "peer"), keep=2)
    for s in (2, 4, 6):
        mirror.push(_snap(s, float(s), (3,)), owner="proc0")
    assert mirror.steps("proc0") == [4, 6]
    got = mirror.fetch("proc0")
    assert got.step == 6 and got.verify()
    path = os.path.join(str(tmp_path / "peer"), "proc0", "snap_step_6.npz")
    with open(path, "wb") as f:
        f.write(b"garbage")
    assert mirror.fetch("proc0").step == 4
    mirror.push(_snap(8, 8.0, (3,)), owner="proc1")
    assert mirror.fetch_any().step == 8
    mirror.clear()
    assert mirror.owners() == []
    with pytest.raises(NotImplementedError, match="ROADMAP: P12"):
        PeerMirror(str(tmp_path / "x"), cluster=object())


# -- restore routing ---------------------------------------------------------

def test_route_restore_newest_wins_and_falls_through(tmp_path):
    sess, batch = _linear_session()
    ckpt, peer = str(tmp_path / "ck"), str(tmp_path / "peer")
    tiers = CheckpointTiers(sess, snapshot_every=1, keep=3, peer_dir=peer)
    saver = Saver(sess)
    sess.run(batch)
    saver.save(ckpt, step=1)
    sess.run(batch)
    tiers.snapshot(step=2)
    w2 = np.asarray(sess.params["linear"]["w"]).copy()
    sess.run(batch)

    fresh, _ = _linear_session()
    t_fresh = CheckpointTiers(fresh, snapshot_every=1, peer_dir=peer)
    step, tier, _ = route_restore(fresh, ckpt, tiers=t_fresh)
    assert (step, tier) == (2, "peer")
    np.testing.assert_array_equal(fresh.params["linear"]["w"], w2)

    step, tier, _ = route_restore(sess, ckpt, tiers=tiers)
    assert (step, tier) == (2, "ram")

    import shutil
    shutil.rmtree(peer)
    fresh2, _ = _linear_session()
    t2 = CheckpointTiers(fresh2, snapshot_every=1, peer_dir=peer)
    step, tier, _ = route_restore(fresh2, ckpt, tiers=t2)
    assert (step, tier) == (1, "persistent")

    fresh3, _ = _linear_session()
    assert route_restore(fresh3, str(tmp_path / "empty")) is None


class _Loader:
    """A stateful shuffling loader (the JAX package's ``DataLoader``'s
    ``state``/``load_state`` contract): epoch ``e``'s order is a
    permutation seeded by ``seed + e``."""

    def __init__(self, data, batch_size, seed):
        self.data, self.bs, self.seed = data, batch_size, seed
        self.epoch, self.offset = 0, 0

    def __iter__(self):
        n = len(next(iter(self.data.values())))
        order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        steps = n // self.bs
        for i in range(self.offset, steps):
            idx = order[i * self.bs:(i + 1) * self.bs]
            yield {k: v[idx] for k, v in self.data.items()}
        self.epoch, self.offset = self.epoch + 1, 0

    def state(self):
        return {"epoch": self.epoch, "offset": self.offset,
                "seed": self.seed}

    def load_state(self, st):
        self.epoch, self.offset = int(st["epoch"]), int(st["offset"])
        return {"epoch": self.epoch, "offset": self.offset}


def test_fit_snapshot_every_and_peer_resume_parity(tmp_path):
    peer = str(tmp_path / "peer")

    def loader():
        rng = np.random.RandomState(1)
        return _Loader({"x": rng.randn(32, 8).astype(np.float32),
                        "y": rng.randn(32, 4).astype(np.float32)},
                       batch_size=8, seed=7)

    oracle, _ = _linear_session()
    oracle.fit(loader(), epochs=3)
    w_oracle = np.asarray(oracle.params["linear"]["w"]).copy()

    a, _ = _linear_session()
    hist = a.fit(loader(), epochs=2, snapshot_every=2, snapshot_dir=peer)
    assert hist.steps_run == 8
    assert os.path.isdir(peer)

    b, _ = _linear_session()
    tiers_b = CheckpointTiers(b, snapshot_every=2, peer_dir=peer)
    hist_b = b.fit(loader(), epochs=3, tiers=tiers_b, resume=True)
    assert hist_b.resume_tier == "peer"
    assert b.step_count == 12
    assert hist_b.steps_run <= 4 + 2
    np.testing.assert_array_equal(b.params["linear"]["w"], w_oracle)
    assert hist_b.goodput and hist_b.goodput["steps"] == hist_b.steps_run


# -- deadline-aware preemption -----------------------------------------------

class _PreemptAt(Callback):
    """Sends ``SIGUSR1`` to this process at ``step`` (what a cloud
    preemption notice does)."""

    def __init__(self, step):
        self.step = step

    def on_step_end(self, step, metrics):
        if step == self.step:
            os.kill(os.getpid(), signal.SIGUSR1)


def _preempt_fit(sess, batch, tmp_path):
    ckpt, peer = str(tmp_path / "ck"), str(tmp_path / "peer")
    hist = sess.fit(batch, epochs=2, steps_per_epoch=4, checkpoint_dir=ckpt,
                    checkpoint_every=1, snapshot_every=2, snapshot_dir=peer,
                    callbacks=[_PreemptAt(3)],
                    preemption_signals=("SIGUSR1",))
    return hist, ckpt, peer


def test_preempt_without_grace_takes_persistent_tier(tmp_path):
    sess, batch = _linear_session()
    hist, ckpt, _ = _preempt_fit(sess, batch, tmp_path)
    assert hist.preempted and hist.preempt_tier == "persistent"
    assert Saver.latest_step(ckpt) == 3


def test_preempt_grace_routes_to_peer_tier(tmp_path, monkeypatch):
    """A grace window and no measured save yet (the first save comes at
    the epoch's end, after the notice): the peer tier takes the state,
    the persistent directory gains nothing at the preempted step, and
    the resume routes through the peer tier."""
    ev.configure(None)
    monkeypatch.setenv("AUTODIST_PREEMPT_GRACE_S", "0.05")
    sess, batch = _linear_session()
    hist, ckpt, peer = _preempt_fit(sess, batch, tmp_path)
    assert hist.preempted and hist.preempt_tier == "peer"
    assert PeerMirror(peer).fetch_any().step == 3
    assert (Saver.latest_step(ckpt) or 0) < 3
    decisions = [e for e in ev.get_journal().events
                 if e.get("kind") == "checkpoint/preempt_decision"]
    assert decisions and decisions[-1]["tier"] == "peer"

    sess2, _ = _linear_session()
    hist2 = sess2.fit(batch, epochs=2, steps_per_epoch=4, checkpoint_dir=ckpt,
                      snapshot_every=2, snapshot_dir=peer)
    assert hist2.resume_tier == "peer"
    # a dict batch has no loader state: the partial epoch re-runs (steps
    # 4..7), then epoch 1, Keras initial_epoch semantics
    assert not hist2.preempted and sess2.step_count == 11


def test_preempt_decision_uses_the_last_measured_save(tmp_path, monkeypatch):
    """A measured durable save slower than the window (1.25x margin) sends
    the state to the peer tier; one well inside it keeps the persistent
    tier."""
    import autodist_tpu_torch.fit as fit_mod

    monkeypatch.setenv("AUTODIST_PREEMPT_GRACE_S", "1.0")
    for measured, want in ((0.9, "peer"), (0.1, "persistent")):
        sess, batch = _linear_session()
        sess.run(batch)
        saver = Saver(sess)
        saver.last_persist_s = measured
        tiers = CheckpointTiers(sess, snapshot_every=0,
                                peer_dir=str(tmp_path / f"p{measured}"))
        got = fit_mod._preempt_save(
            session=sess, saver=saver, tiers=tiers,
            checkpoint_dir=str(tmp_path / f"c{measured}"),
            data_track={"enabled": False, "pos": None},
            guard_state={"last_finite": None}, monitor=None,
            goodput={"ckpt_stall_s": 0.0})
        assert got == want


# -- the logical-to-session import, shared with the Saver --------------------

@pytest.mark.parametrize("strategy", ["zero1", "PSLoadBalancing"])
def test_snapshot_restores_as_the_saver_does(strategy, tmp_path):
    """A ZeRO-1 session's snapshot and its checkpoint of the same step
    restore to the same shards, and the continuation is bit-exact."""
    sess, batch = worker.session(strategy)
    for _ in range(2):
        sess.run(batch)
    snap = capture_snapshot(sess)
    path = Saver(sess).save(str(tmp_path / "ck"))
    losses = [float(sess.run(batch)["loss"]) for _ in range(2)]
    want = dict(flatten(sess.params))

    for restore in (lambda s: load_snapshot(s, snap),
                    lambda s: Saver(s).restore(path)):
        other, _ = worker.session(strategy)
        assert restore(other) == 2
        assert [float(other.run(batch)["loss"]) for _ in range(2)] == losses
        got = dict(flatten(other.params))
        assert all(np.array_equal(got[n], want[n]) for n in want)


def test_snapshot_of_stale_and_proxy_state_resumes_bit_exact():
    """Bounded staleness keeps a queue of delayed gradients in the sync
    state: a snapshot carries it (logical) and the resume is exact."""
    sess, batch = worker.lm_session(PS(staleness=2),
                                    opt=optim.adam(1e-2))
    for _ in range(3):
        sess.run(batch)
    snap = capture_snapshot(sess)
    assert "sync_state" in snap.leaves
    losses = [float(sess.run(batch)["loss"]) for _ in range(3)]
    other, _ = worker.lm_session(PS(staleness=2), opt=optim.adam(1e-2))
    load_snapshot(other, snap)
    assert [float(other.run(batch)["loss"]) for _ in range(3)] == losses


def test_route_restore_of_another_zero1_layout_names_p9(tmp_path):
    """A persistent checkpoint written under another ZeRO-1 bucket layout
    (another data-axis size) is elastic resume: routing raises naming P9,
    as ``Saver.restore`` does, instead of skipping it."""
    import json

    sess, batch = worker.session("zero1")
    sess.run(batch)
    path = Saver(sess).save(str(tmp_path / "e"))
    meta_file = os.path.join(path, "autodist_meta.json")
    meta = json.loads(open(meta_file).read())
    for entry in meta["zero1_buckets"]:
        entry["padded_total"] += 2
    meta["data_axis_size"] = 2
    with open(meta_file, "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotImplementedError,
                       match="ROADMAP: P9 — telemetry and resilience"):
        route_restore(worker.session("zero1")[0], str(tmp_path / "e"))


def test_snapshot_of_another_mesh_or_program_refuses():
    sess, batch = _linear_session()
    sess.run(batch)
    snap = capture_snapshot(sess)
    snap.meta["mesh_axes"] = {"data": 8}
    with pytest.raises(SnapshotError, match="same-mesh"):
        load_snapshot(sess, snap)
    other, _ = worker.session("allreduce")
    with pytest.raises(SnapshotError, match="program changed"):
        load_snapshot(other, capture_snapshot(sess))
