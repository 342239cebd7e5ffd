"""The port's MPMD pipeline runtime (``autodist_tpu_torch.parallel.mpmd``)
against the JAX package's.

* the partitioner: ``assign_layers``, ``partition_params``' names, the
  ``restage_params`` round trip and the torn-save raise, and
  ``preflight_stage_resize``'s verdicts equal JAX's over (layers,
  stages); ``build_pipeline_ir``'s fingerprint equals JAX's over
  ``zero1`` x ``data_axis`` x stages;
* the transport: the in-memory round trip and timeout, the directory
  plane's non-consuming reads, ``gc`` and the skipped corrupt blob, and
  blobs crossing between the packages both ways;
* the runner in one process (the JAX test's tanh layers, S 2, M 4,
  stages on threads over the in-memory transport): each step's loss
  within 1e-6 of JAX's ``StageRunner`` and the final parameters within
  rtol 1e-5, the losses within 1e-5 of the port's ``one_f_one_b``;
  ``make_zero1_update`` at d 1 equals SGD;
* on gloo (``tests/torch_mpmd_worker.py``): two stage groups of two
  ranks, each group its own world, ZeRO-1 off and on: losses within 1e-5
  of one process, one digest per stage group; the chaos drill
  (``kill@step=1,proc=0,attempt=0,stage=1``, the stage-1 group relaunched by a
  ``Supervisor`` as attempt 1) reproduces the clean job's losses and
  parameter checksums bit for bit, with one fingerprint everywhere.

Torch runs one intra-op thread.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.parallel import mpmd as jmpmd
from autodist_tpu.parallel.mpmd import transport as jtmod
from autodist_tpu.resilience.elastic import \
    ElasticResumeError as JElasticResumeError
from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
from autodist_tpu_torch.parallel import mpmd
from autodist_tpu_torch.parallel.mpmd import transport as tmod
from autodist_tpu_torch.parallel.pipeline_1f1b import one_f_one_b
from autodist_tpu_torch.resilience.elastic import ElasticResumeError

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402
import torch_mpmd_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_mpmd_worker.py"
L, D = 4, 8
S, M = 2, 4
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    tmod.reset_registry()
    jtmod.reset_registry()
    # a StageRunner stamps AUTODIST_STAGE into the environment: keep the
    # stamp from reaching the tests that run after these in this process
    monkeypatch.setenv("AUTODIST_STAGE", "")


def _layers(seed=0, n=L, d=D):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) * 0.3).astype(np.float32),
             "b": (rng.randn(d) * 0.1).astype(np.float32)}
            for _ in range(n)]


# -- partitioner --------------------------------------------------------------

@pytest.mark.parametrize("layers,stages", [(4, 2), (5, 2), (7, 3), (4, 4),
                                           (2, 3), (8, 1)])
def test_partition_matches_jax(layers, stages):
    ls = _layers(n=layers)
    if stages > layers:
        for fn, err in ((mpmd.assign_layers, ValueError),
                        (jmpmd.assign_layers, ValueError)):
            with pytest.raises(err, match=sir.RULE_STAGE_MISMATCH):
                fn(layers, stages)
        return
    assert mpmd.assign_layers(layers, stages) \
        == jmpmd.assign_layers(layers, stages)
    part, st = mpmd.partition_params(ls, stages)
    jpart, jst = jmpmd.partition_params(ls, stages)
    assert part.layers == jpart.layers and part.catalog == jpart.catalog
    assert [sorted(s) for s in st] == [sorted(s) for s in jst]
    assert part.to_meta() == jpart.to_meta()
    assert [part.param_names(i) for i in range(stages)] \
        == [jpart.param_names(i) for i in range(stages)]
    for i, sp in enumerate(st):
        assert {sir.stage_of(n) for n in sp} == {sir.stage_name(i)}
    other = 1 if stages > 1 else min(2, layers)
    moved, jmoved = (mpmd.restage_params(st, other),
                     jmpmd.restage_params(jst, other))
    assert [sorted(s) for s in moved] == [sorted(s) for s in jmoved]
    back = mpmd.restage_params(moved, stages)
    for a, b in zip(st, back):
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    if stages > 1:
        torn = [dict(s) for s in st]
        name = sorted(st[1])[0]
        torn[0][name.replace("stage1/", "stage0/")] = st[1][name]
        with pytest.raises(ElasticResumeError, match="torn save"):
            mpmd.restage_params(torn, stages)
        with pytest.raises(JElasticResumeError, match="torn save"):
            jmpmd.restage_params(torn, stages)
    assert mpmd.strip_stage("stage1/l2/w") == jmpmd.strip_stage(
        "stage1/l2/w") == "l2/w"


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("data_axis", [1, 2])
@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_ir_fingerprint_matches_jax(zero1, data_axis, stages):
    kw = dict(layer_params=_layers(n=8), num_stages=stages,
              num_microbatches=4, act_nbytes=2 * D * 4,
              data_axis=data_axis, zero1=zero1, bucket_bytes=1 << 20)
    prog, jprog = mpmd.build_pipeline_ir(**kw), jmpmd.build_pipeline_ir(**kw)
    assert prog.ir.fingerprint() == jprog.ir.fingerprint()
    assert prog.fingerprint() == jprog.fingerprint()
    assert json.dumps(prog.ir.to_dict(), sort_keys=True) \
        == json.dumps(jprog.ir.to_dict(), sort_keys=True)
    assert not sir.errors(sir.verify(prog.ir))
    rebuilt = sir.ir_from_facts(list(prog.facts), axes=dict(prog.axes),
                                accum_steps=4, pipeline=list(prog.pipeline))
    assert rebuilt.fingerprint() == prog.ir.fingerprint()


@pytest.mark.parametrize("stages,mbs", [(4, 4), (8, None), (4, 2), (1, 4),
                                        (2, 8)])
def test_preflight_stage_resize_matches_jax(stages, mbs):
    kw = dict(layer_params=_layers(), num_stages=S, num_microbatches=M,
              act_nbytes=2 * D * 4)
    prog, jprog = mpmd.build_pipeline_ir(**kw), jmpmd.build_pipeline_ir(**kw)
    meta = {"partition": prog.partition.to_meta(), "num_microbatches": M,
            "act_nbytes": 2 * D * 4}
    args = dict(num_stages=stages, num_microbatches=mbs)
    try:
        want = jmpmd.preflight_stage_resize(meta, **args)
    except JElasticResumeError as e:
        with pytest.raises(ElasticResumeError) as got:
            mpmd.preflight_stage_resize(meta, **args)
        assert str(got.value) == str(e)
        return
    got = mpmd.preflight_stage_resize(meta, **args)
    assert got.partition.num_stages == stages
    assert got.fingerprint() == want.fingerprint()
    assert got.ir.fingerprint() == want.ir.fingerprint()
    assert (got.fingerprint() != prog.fingerprint()) \
        == (want.fingerprint() != jprog.fingerprint())


# -- transport ----------------------------------------------------------------

def test_transport_inmemory_roundtrip_and_timeout():
    tr = mpmd.ActivationTransport("", channel="dp0", timeout_s=0.2)
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    tr.send("act:pipe/f0@0", v)
    assert np.array_equal(tr.recv("act:pipe/f0@0"), v)
    other = mpmd.ActivationTransport("", channel="dp1", timeout_s=0.05)
    with pytest.raises(mpmd.TransportTimeout, match="act:pipe/f0@0"):
        other.recv("act:pipe/f0@0")


def test_transport_directory_nonconsuming_and_gc(tmp_path):
    a = mpmd.ActivationTransport(str(tmp_path), channel="dp0", timeout_s=1.0)
    v = np.ones((4,), np.float32)
    a.send("s2/act:pipe/f0@0", v)
    tmod.reset_registry()   # force the directory path
    b = mpmd.ActivationTransport(str(tmp_path), channel="dp0", timeout_s=1.0)
    assert np.array_equal(b.recv("s2/act:pipe/f0@0"), v)
    assert np.array_equal(b.recv("s2/act:pipe/f0@0"), v)   # not consumed
    assert b.gc("s2/") >= 1
    with pytest.raises(mpmd.TransportTimeout):
        b.recv("s2/act:pipe/f0@0", timeout_s=0.05)


def test_transport_corrupt_blob_skipped_then_retransmitted(tmp_path):
    tr = mpmd.ActivationTransport(str(tmp_path), channel="dp0",
                                  timeout_s=5.0, poll_s=0.005)
    with open(tr._path("act:pipe/f0@0"), "wb") as f:
        f.write(b"ADTPUACT1 garbage that fails the digest")
    v = np.full((3,), 7.0, np.float32)
    seen = threading.Event()
    real = tmod._decode

    def decode(blob):     # the retransmit lands after the corrupt read
        out = real(blob)
        if out is None and not seen.is_set():
            seen.set()
            good = mpmd.ActivationTransport(str(tmp_path), channel="dp0")
            good.send("act:pipe/f0@0", v)
            tmod.reset_registry()
        return out
    tmod._decode = decode
    try:
        got = tr.recv("act:pipe/f0@0")
    finally:
        tmod._decode = real
    assert seen.is_set() and np.array_equal(got, v)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_transport_blobs_cross_between_packages(tmp_path, writer):
    v = np.random.RandomState(3).randn(2, 5).astype(np.float32)
    mods = {"port": (mpmd, tmod), "jax": (jmpmd, jtmod)}
    reader = "jax" if writer == "port" else "port"
    wmod, wt = mods[writer]
    rmod, rt = mods[reader]
    wmod.ActivationTransport(str(tmp_path), channel="dp1").send(
        "s0/act:pipe/f0@1", v)
    wt.reset_registry()
    got = rmod.ActivationTransport(str(tmp_path), channel="dp1",
                                   timeout_s=1.0).recv("s0/act:pipe/f0@1")
    assert got.dtype == v.dtype and np.array_equal(got, v)
    with open(tmod.ActivationTransport(str(tmp_path), channel="dp1")._path(
            "s0/act:pipe/f0@1"), "rb") as f:
        assert f.read() == tmod._encode(v) == jtmod._encode(v)


# -- the runner ---------------------------------------------------------------

def test_make_zero1_update_degenerate_matches_sgd():
    upd = mpmd.make_zero1_update(None, lr=0.1, num_shards=1)
    p = torch.arange(8, dtype=torch.float32)
    g = torch.ones(8)
    assert torch.equal(upd(g, p), p - 0.1 * g)


def _threads(runners, x_mbs, t_mbs):
    res = [None] * len(runners)

    def run(si):
        res[si] = runners[si].run_step(
            x_mbs if si == 0 else None,
            t_mbs if si == len(runners) - 1 else None)
    ths = [threading.Thread(target=run, args=(si,))
           for si in range(len(runners))]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    return res[-1]


def test_two_stage_runner_matches_jax_and_one_f_one_b():
    layers = _layers()
    part, stage_params = mpmd.partition_params(layers, S)
    kw = dict(layer_params=layers, num_stages=S, num_microbatches=M,
              act_nbytes=2 * D * 4)
    prog, jprog = mpmd.build_pipeline_ir(**kw), jmpmd.build_pipeline_ir(**kw)
    rng = np.random.RandomState(1)
    x = rng.randn(8, D).astype(np.float32)
    tgt = rng.randn(8, D).astype(np.float32)
    rows = 8 // M
    x_mbs = [x[i * rows:(i + 1) * rows] for i in range(M)]
    t_mbs = [tgt[i * rows:(i + 1) * rows] for i in range(M)]

    def jstage(si):
        def fn(p, h):
            for j in part.layers[si]:
                pre = f"{jsir.stage_name(si)}/l{j}"
                h = jnp.tanh(h @ p[f"{pre}/w"] + p[f"{pre}/b"])
            return h
        return fn

    def jmse(y, t):
        return jnp.mean((y - t) ** 2)

    runners = [mpmd.StageRunner(
        prog, si, stage_fn=worker.stage_fn_for(si), params=stage_params[si],
        transport=mpmd.ActivationTransport("", channel="dp0"), lr=0.1,
        loss_fn=worker.mse if si == S - 1 else None, device="cpu")
        for si in range(S)]
    jrunners = [jmpmd.StageRunner(
        jprog, si, stage_fn=jstage(si), params=stage_params[si],
        transport=jmpmd.ActivationTransport("", channel="dp0"), lr=0.1,
        loss_fn=jmse if si == S - 1 else None) for si in range(S)]
    assert runners[0].fingerprint == jrunners[0].fingerprint
    assert os.environ["AUTODIST_STAGE"] == "stage1"
    losses = [_threads(runners, x_mbs, t_mbs) for _ in range(STEPS)]
    jlosses = [_threads(jrunners, x_mbs, t_mbs) for _ in range(STEPS)]
    assert max(abs(a - b) for a, b in zip(losses, jlosses)) <= 1e-6
    for r, jr in zip(runners, jrunners):
        assert sorted(r.params) == sorted(jr.params)
        for n in r.params:
            np.testing.assert_allclose(r.params[n].numpy(),
                                       np.asarray(jr.params[n]), rtol=1e-5,
                                       atol=1e-7)

    stack = {k: torch.from_numpy(np.stack([
        np.stack([layers[j][k] for j in run]) for run in part.layers]))
        for k in ("w", "b")}

    def sfn(p, h):
        for j in range(p["w"].shape[0]):
            h = torch.tanh(h @ p["w"][j] + p["b"][j])
        return h
    oracle = []
    for _ in range(STEPS):
        loss, grads, _ = one_f_one_b(sfn, worker.mse, stack,
                                     torch.from_numpy(x),
                                     torch.from_numpy(tgt), None,
                                     num_microbatches=M)
        stack = {k: stack[k] - 0.1 * grads[k] for k in stack}
        oracle.append(float(loss))
    assert max(abs(a - b) for a, b in zip(losses, oracle)) <= 1e-5


def test_runner_snapshot_restores_bit_exact(tmp_path):
    layers = _layers()
    _, stage_params = mpmd.partition_params(layers, S)
    prog = mpmd.build_pipeline_ir(layer_params=layers, num_stages=S,
                                  num_microbatches=M, act_nbytes=2 * D * 4)
    runners = [mpmd.StageRunner(
        prog, si, stage_fn=worker.stage_fn_for(si), params=stage_params[si],
        transport=mpmd.ActivationTransport("", channel="dp0"),
        loss_fn=worker.mse if si == S - 1 else None,
        state_dir=str(tmp_path), device="cpu") for si in range(S)]
    x = np.random.RandomState(2).randn(8, D).astype(np.float32)
    mbs = [x[i * 2:(i + 1) * 2] for i in range(M)]
    _threads(runners, mbs, mbs)
    again = mpmd.StageRunner(
        prog, 1, stage_fn=worker.stage_fn_for(1), params=stage_params[1],
        transport=mpmd.ActivationTransport("", channel="dp0"),
        loss_fn=worker.mse, state_dir=str(tmp_path), device="cpu")
    assert again.step == 1
    assert all(torch.equal(again.params[n], runners[1].params[n])
               for n in again.params)
    meta = runners[1].meta()
    assert meta["schedule_fingerprint"] == prog.ir.fingerprint()
    assert mpmd.preflight_stage_resize(meta, num_stages=4).partition \
        .num_stages == 4


# -- two stage worlds of two gloo ranks ---------------------------------------

def _launch_stage(stage, workdir, mode, tmp, env=None):
    return torch_launch.Launch(
        lambda rank, init: [WORKER, stage, rank, init, workdir, mode],
        world=worker.DP, tmp_dir=tmp, env=env)


def _read_job(workdir):
    """``(losses by step, {proc: (checksum, digest)}, fingerprints)`` of
    one job's logs; a replayed step's LAST entry is the one kept."""
    losses, final, fps = {}, {}, set()
    for st in range(worker.S):
        for r in range(worker.DP):
            with open(os.path.join(workdir, f"steps.s{st}r{r}"),
                      encoding="utf-8") as f:
                for line in f:
                    rec = json.loads(line)
                    fps.add(rec["fingerprint"])
                    if rec.get("done"):
                        final[f"s{st}r{r}"] = (rec["checksum"],
                                               rec["digest"])
                    elif st == worker.S - 1:
                        losses.setdefault(r, {})[rec["step"]] = rec["loss"]
    # the DP mean on every rank (a killed rank lacks its last step)
    assert all(losses[0][k] == v for k, v in losses[1].items()
               if k in losses[0])
    merged = {**losses[1], **losses[0]}
    return [merged[k] for k in range(worker.STEPS)], final, fps


def _one_process_losses(zero1):
    """The same job at d 1: both DP halves in one microbatch."""
    layers, x, tgt = worker.case()
    _, stage_params = mpmd.partition_params(layers, worker.S)
    prog = worker.program(zero1, data_axis=1)
    runners = [mpmd.StageRunner(
        prog, si, stage_fn=worker.stage_fn_for(si), params=stage_params[si],
        transport=mpmd.ActivationTransport("", channel=f"one{zero1}"),
        lr=worker.LR, loss_fn=worker.mse if si == worker.S - 1 else None,
        zero1=zero1, device="cpu") for si in range(worker.S)]
    x_mbs = worker.microbatches(x, 0, dp=1)
    t_mbs = worker.microbatches(tgt, 0, dp=1)
    return [_threads(runners, x_mbs, t_mbs) for _ in range(worker.STEPS)]


def test_stage_worlds_on_gloo_and_chaos_drill(tmp_path):
    from autodist_tpu_torch.resilience import (Backoff, Supervisor,
                                               SupervisorPolicy)

    clean = str(tmp_path / "clean")
    runs = [_launch_stage(st, clean, "clean", tmp_path)
            for st in range(worker.S)]
    for run in runs:
        run.wait(240)
    jobs = {job: _read_job(os.path.join(clean, job)) for job in worker.JOBS}
    fingerprints = {job: worker.program(z).ir.fingerprint()
                    for job, z in worker.JOBS.items()}
    for job, zero1 in worker.JOBS.items():
        losses, final, fps = jobs[job]
        ref = _one_process_losses(zero1)
        assert max(abs(a - b) for a, b in zip(losses, ref)) <= 1e-5, \
            (job, losses, ref)
        for st in range(worker.S):       # one digest per stage group
            assert final[f"s{st}r0"] == final[f"s{st}r1"], (job, st)
        assert fps == {fingerprints[job]}

    chaos = str(tmp_path / "chaos")
    os.makedirs(chaos)
    env = {"AUTODIST_CHAOS": "kill@step=1,proc=0,attempt=0,stage=1",
           "AUTODIST_FLIGHTREC": "0"}
    reports = {}

    def supervise(stage):
        def launch(att):
            # each rank in a session of its own: the supervisor ends a
            # failed attempt by signalling its process groups
            init = torch_launch.rendezvous(tmp_path)
            return {f"s{stage}r{r}": subprocess.Popen(
                [sys.executable, str(WORKER), str(stage), str(r), init,
                 chaos, "chaos"],
                env=torch_launch.rank_env(dict(env, **att.env())),
                stdout=subprocess.DEVNULL, start_new_session=True)
                for r in range(worker.DP)}
        sup = Supervisor(SupervisorPolicy(
            max_restarts=1, poll_interval=0.05, kill_grace=5.0,
            backoff=Backoff(max_tries=2, base=0.01, cap=0.01)),
            workdir=str(tmp_path / f"sup{stage}"))
        reports[stage] = sup.run(launch)
    threads = [threading.Thread(target=supervise, args=(st,))
               for st in range(worker.S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert reports[0].ok and reports[0].attempts == 1
    assert reports[1].ok and reports[1].attempts == 2, reports[1]
    losses, final, fps = _read_job(os.path.join(chaos, "chaos"))
    clean_losses, clean_final, clean_fps = jobs["zero1"]
    assert losses == clean_losses           # bit for bit
    assert {k: v[0] for k, v in final.items()} \
        == {k: v[0] for k, v in clean_final.items()}
    assert final == clean_final
    assert fps == clean_fps == {fingerprints["zero1"]}
