"""The slice end to end on the CPU: ``AutoStrategy(search="beam")`` →
``create_distributed_session(validate=True)`` → 3 steps, the losses within
1e-5 of the JAX package's run of the same builder on one device; and one
4-rank gloo run (``tests/torch_launch.py``, ``tests/torch_dp_worker.py``
mode ``auto``) at data size 4 whose losses are within 1e-5 and final
parameters within 1e-4 of the JAX package's 4-device run, the ranks
bit-identical: only rank 0 searches and the others take its plan, which
their own searches, cut to one candidate, would not have picked.  Both packages price with the same constants (the
calibration of ``tests/test_torch_search.py``).  On the CPU the port's
kernels run their plain versions.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import autodist_tpu.strategy as jstrategy
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402
from test_torch_search import (CFG, _jax_params,  # noqa: E402,F401
                               same_constants)

pytestmark = pytest.mark.torch_port


def _batch():
    return jax_lm(**CFG).sample_batch(8, seed=1)


def _jax_run(params, chips, steps):
    jax_reset()
    jspec = jax_lm(**CFG, attn_fn=jax_dense)
    rs = JResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "chips": chips}]})
    builder = jstrategy.AutoStrategy(search="beam")
    ad = JAutoDist(resource_spec=rs, strategy_builder=builder)
    with ad.scope():
        ad.capture(params=params, optimizer=jax_fusable_adam(1e-3),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars,
                   numerics={"clip_norm": 1.0})
    sess = ad.create_distributed_session(
        mesh=jax_build_mesh({"data": chips}, devices=jax.devices()[:chips]),
        validate=True)
    batch = _batch()
    losses = [float(sess.run(batch)["loss"]) for _ in range(steps)]
    return builder, losses, jax.tree.map(np.asarray, sess.params)


def test_slice_on_one_device_trains_as_the_jax_package():
    params = _jax_params()
    jbuilder, jlosses, _ = _jax_run(params, 1, 3)
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)
    builder = strategy.AutoStrategy(search="beam")
    ad = AutoDist(resource_spec=ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "chips": 1}]}),
        strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=fusable_adam(1e-3), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars, numerics={"clip_norm": 1.0})
    sess = ad.create_distributed_session(validate=True)
    assert builder.last_choice == jbuilder.last_choice
    batch = {k: np.asarray(v) for k, v in _batch().items()}
    losses = [float(sess.run(batch)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert all(r.schedule_fingerprint == sess.schedule_fingerprint
               for r in sess.telemetry.records)


def test_slice_on_four_gloo_ranks_trains_as_the_jax_package(tmp_path):
    params = _jax_params()
    jbuilder, jlosses, jparams = _jax_run(params, 4, worker.STEPS)
    inp = tmp_path / "in.npz"
    np.savez(inp, **{f"p:{k}": v for k, v in flatten(params)},
             **{f"b:{k}": np.asarray(v) for k, v in _batch().items()})
    outs = [tmp_path / f"rank{r}.npz" for r in range(4)]
    torch_launch.run(lambda rank, init: [worker.__file__, rank, 4, init,
                                         outs[rank], "auto", inp],
                     world=4, tmp_dir=tmp_path, timeout=300)
    runs = [np.load(o) for o in outs]
    # only rank 0 searches (the others, cut to one candidate, would have
    # picked another plan); every rank lowers its plan
    assert str(runs[0]["choice"]) == jbuilder.last_choice
    assert [str(r["choice"]) for r in runs[1:]] == [""] * 3
    assert len({str(r["strategy_id"]) for r in runs}) == 1
    assert len({str(r["fingerprint"]) for r in runs}) == 1
    for run in runs:
        np.testing.assert_allclose(run["losses"], jlosses, rtol=1e-5)
        for name, want in flatten(jparams):
            np.testing.assert_allclose(run[f"p:{name}"], want, atol=1e-4,
                                       err_msg=name)
    for name, _ in flatten(jparams):
        assert all(np.array_equal(runs[0][f"p:{name}"], r[f"p:{name}"])
                   for r in runs[1:])


def test_ranks_that_lower_different_schedules_raise(monkeypatch):
    from autodist_tpu_torch import autodist as facade

    def gather(out, obj):
        out[:] = [obj, "another"]
    monkeypatch.setattr(facade.dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(facade.dist, "all_gather_object", gather)
    with pytest.raises(RuntimeError, match="different schedules"):
        facade._check_ranks_agree("fp")


def test_a_failed_chief_build_raises_on_every_rank(monkeypatch):
    from autodist_tpu_torch import autodist as facade

    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=strategy.AllReduce(), device="cpu")
    monkeypatch.setattr(facade.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(facade.dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(facade.dist, "broadcast_object_list",
                        lambda payload, src, device: None)
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        ad._chief_strategy()
