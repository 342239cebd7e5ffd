"""The BASELINE configurations (BASELINE.json) of the port on 2 gloo CPU
ranks against the JAX package.

Each of :data:`torch_dp_worker.MODEL_RUNS` (ResNet + ``AllReduce`` + sgd
with momentum, VGG16 + ``PartitionedPS`` + sgd with the clip, BERT +
``PartitionedAR`` + adamw, lm1b + ``Parallax`` + adagrad, NCF +
``PSLoadBalancing`` + ``fusable_adam`` with the clip, its four tables on
the reduce-scatter buckets of K4/K5's plain versions), a tiny model of
the family, trains 3 steps on 2 gloo ranks in one launch of
``tests/torch_dp_worker.py`` (mode ``models``, started with the module so
it runs beside the JAX sessions), against the JAX session on its 8-device
CPU mesh from the same weights (the JAX init) and the same global batch:
losses at rtol 1e-5, parameters at atol 1e-4 (``tests/test_torch_zero1.py``'s
tolerances); lm1b's adagrad state, its tables' in reduce-scatter buckets,
at atol 1e-4, and through ``convert.opt_state_from_jax``.  BERT's masked
mean is the global batch's on both sides (``models.base.masked_mean``).
"""
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import opt_state_from_jax, params_from_jax
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    pack_bucket, unpack_bucket)
from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
    plan_step_buckets
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_models as tm  # noqa: E402
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


@pytest.fixture(scope="module")
def model_inputs():
    """Each configuration's JAX spec, JAX init weights and global batch."""
    out = {}
    for name in worker.MODEL_RUNS:
        jspec = tm._jax_spec(name)
        out[name] = (jspec, tm._jax_params(jspec),
                     jspec.sample_batch(worker.MODEL_BATCH, seed=1))
    return out


@pytest.fixture(scope="module", autouse=True)
def gloo_models(tmp_path_factory, model_inputs):
    """Starts the 2-rank gloo pair in ``models`` mode; ``gloo_models()``
    waits for it and returns both ranks' outputs."""
    tmp = tmp_path_factory.mktemp("models")
    data = {}
    for name, (_, params, batch) in model_inputs.items():
        data.update({f"{name}/p/{n}": x for n, x in flatten(params)})
        data.update({f"{name}/b/{k}": np.asarray(v) for k, v in batch.items()})
    np.savez(tmp / "in.npz", **data)
    launch = torch_launch.Launch(
        lambda rank, init: [WORKER, rank, 2, init, tmp / f"rank{rank}.npz",
                            "models", tmp / "in.npz"],
        world=2, tmp_dir=tmp)
    result = []

    def wait():
        if not result:
            launch.wait(300)
            result.extend(np.load(tmp / f"rank{r}.npz") for r in range(2))
        return result
    yield wait
    launch.kill()


@pytest.fixture(scope="module")
def jax_runs(model_inputs):
    """``jax_runs(name)``: the JAX session of configuration ``name`` on the
    8-device CPU mesh, 3 steps: losses, final parameters, exported
    optimizer state."""
    runs = {}

    def run(name):
        if name not in runs:
            jspec, params, batch = model_inputs[name]
            builder, opt, kw, numerics = worker.MODEL_RUNS[name]
            jax_reset()
            optimizer = jax_fusable_adam(**kw) if opt == "fusable_adam" \
                else getattr(optax, opt)(**kw)
            ad = JAutoDist(strategy_builder=getattr(jstrategy, builder)())
            with ad.scope():
                ad.capture(params=params, optimizer=optimizer,
                           loss_fn=jspec.loss_fn,
                           sparse_vars=jspec.sparse_vars, numerics=numerics)
            sess = ad.create_distributed_session()
            assert sess.mesh.shape["data"] == 8
            losses = [float(sess.run(batch)["loss"])
                      for _ in range(worker.STEPS)]
            runs[name] = (losses, jax.tree.map(np.asarray,
                                               sess.export_state()))
        return runs[name]
    return run


@pytest.mark.parametrize("name", list(worker.MODEL_RUNS))
def test_baseline_config_on_two_gloo_ranks_matches_jax(name, jax_runs,
                                                       gloo_models):
    losses, (jparams, _) = jax_runs(name)
    for out in gloo_models():
        if name == "ncf":       # the four tables' buckets through K4/K5
            assert tuple(out["ncf/fused_kernels"]) == ("guard", "update")
        np.testing.assert_allclose(out[f"{name}/losses"], losses, rtol=1e-5)
        prefix = f"{name}/p:"
        got = {k[len(prefix):]: out[k] for k in out.files
               if k.startswith(prefix)}
        want = dict(flatten(jparams))
        assert got.keys() == want.keys()
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-4,
                                       err_msg=n)


def test_lm1b_adagrad_state_on_two_gloo_ranks_matches_jax(
        model_inputs, jax_runs, gloo_models):
    """lm1b under ``Parallax``: the tables' adagrad state in reduce-scatter
    buckets (1/2 per rank, gathered by ``export_state``), the rest per
    variable, equal to the JAX session's per-variable state at atol 1e-4;
    ``opt_state_from_jax`` packs the JAX state into the same buckets, and
    its two rank shards reassemble them."""
    _, (_, jopt) = jax_runs("lm1b")
    plain = dict(flatten(opt_state_from_jax(jopt)["sum_of_squares"]))
    spec = worker.model_spec("lm1b")
    gi = GraphItem(params_from_jax(model_inputs["lm1b"][1]),
                   sparse_vars=spec.sparse_vars)
    compiled = StrategyCompiler(None).compile(strategy.Parallax().build(
        gi, ResourceSpec(resource_info=tm.ONE_NODE)), gi)
    plan = [b for b in plan_step_buckets(gi, compiled, 2)
            if b.mode == "reduce_scatter"]
    assert sorted(n for b in plan for n in b.names) == \
        ["embedding", "softmax_embedding"]
    for out in gloo_models():
        got = {k[len("lm1b/vars:"):]: out[k] for k in out.files
               if k.startswith("lm1b/vars:")}
        for b in plan:
            got.update((n, x.numpy()) for n, x in zip(
                b.names, unpack_bucket(b, torch.from_numpy(
                    out[f"lm1b/zero1:{b.key}"]))))
        assert got.keys() == plain.keys()
        for n, x in plain.items():
            np.testing.assert_allclose(got[n], x.numpy(), rtol=0, atol=1e-4,
                                       err_msg=n)
    full = opt_state_from_jax(jopt, zero1_buckets=plan)["zero1"]
    halves = [opt_state_from_jax(jopt, zero1_buckets=plan, rank=r, data=2)
              for r in range(2)]
    for b in plan:
        torch.testing.assert_close(
            torch.cat([h["zero1"]["sum_of_squares"][b.key] for h in halves]),
            full["sum_of_squares"][b.key], rtol=0, atol=0)
        torch.testing.assert_close(
            full["sum_of_squares"][b.key],
            pack_bucket(b, [plain[n] for n in b.names]), rtol=0, atol=0)
