"""1/N parameter storage of PS-partitioned and sparse-on-PS variables, on 4
gloo CPU ranks against the JAX package on its 4-device CPU mesh.

The JAX lowering gives such a variable ``param_spec = P("data")`` (a
partitioner's axis under PS, axis 0 of a sparse table on PS), and its step
keeps it sharded between steps.  The port stores the same variables 1/N:
a rank holds its chunk of the variable's flat ZeRO-1 bucket and gathers a
compute copy at the start of each step.  Here, on the LM at width 32 (2
layers, vocab 96, and 97 for ``UnevenPartitionedPS``, which JAX pads on 4
devices), one launch of 4 ranks (``tests/torch_dp_worker.py`` mode
``storage``, one intra-op thread each) runs every case of
``worker.STORAGE_CASES`` and shows that:

* the variables stored 1/N are those JAX's compiler shards over ``data``
  (a proxied one keeps the replicated mirror, the JAX rule for proxies);
* each rank holds ``padded_total // 4`` elements of every stored bucket,
  its parts of the members (a lone ``embed`` of 96 rows: JAX's 24-row
  shard, element for element), and the full value of everything else;
  ``restore_targets`` still gives the logical shapes, and
  ``flops_per_step`` counts the step;
* losses at rtol 1e-5 and parameters at atol 1e-4 of the JAX session, the
  ranks bit-identical;
* a checkpoint written on 4 ranks restores on 1 and one written on 1
  restores on 4, bit for bit;
* a numerics rollback restores the shards bit for bit: the poisoned run
  ends on the clean run's shards, moments and parameters.
"""
import os
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.graph_item import GraphItem, flatten
from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
    plan_step_buckets
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch import strategy
from autodist_tpu_torch.strategy import StrategyCompiler

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
CASES = worker.STORAGE_CASES
RANKS = 4
NUMERICS = {"clip_norm": worker.CLIP}


def _params(vocab):
    """The port's init from seed 0 as numpy: the weights both packages and
    every rank start from."""
    return params_to_numpy(transformer_lm(vocab_size=vocab,
                                          **worker.STORAGE_CFG)
                           .init(0, device="cpu"))


def _batch(vocab):
    return transformer_lm(vocab_size=vocab,
                          **worker.STORAGE_CFG).sample_batch(8, seed=1)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The ranks' input file, their checkpoint directory holding the
    1-rank checkpoints they restore, and those sessions' logical state."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("storage")
    data, one = {}, {}
    for vocab in {c[2] for c in CASES.values()}:
        data.update({f"v{vocab}/p/{n}": x
                     for n, x in flatten(_params(vocab))})
        data[f"v{vocab}/tokens"] = _batch(vocab)["tokens"]
    np.savez(tmp / "in.npz", **data)
    for case in worker.STORAGE_CKPT_CASES:
        vocab = CASES[case][2]
        sess, _ = worker.storage_session(case, _params(vocab))
        for _ in range(2):
            sess.run(_batch(vocab))
        Saver(sess).save(str(tmp / "ck" / f"{case}_one"))
        one[case] = {}
        worker.storage_state(one[case], "s", sess)
    return tmp, one


@pytest.fixture(scope="module")
def ranks(inputs):
    """``ranks()``: the 4 ranks' outputs (started with the module, waited
    for at first use)."""
    tmp, _ = inputs
    launch = torch_launch.Launch(
        lambda rank, init: [WORKER, rank, RANKS, init,
                            tmp / f"rank{rank}.npz", "storage",
                            tmp / "in.npz", tmp / "ck"],
        world=RANKS, tmp_dir=tmp)
    result = []

    def wait():
        if not result:
            launch.wait(300)
            result.extend(dict(np.load(tmp / f"rank{r}.npz"))
                          for r in range(RANKS))
        return result
    yield wait
    launch.kill()


def _jax_mesh():
    return jax_build_mesh({"data": RANKS}, devices=jax.devices()[:RANKS])


@pytest.fixture(scope="module")
def jax_run():
    """``jax_run(case)``: the JAX session of ``case`` on the 4-device
    mesh from the same weights: losses, parameters, the evaluation loss
    and the per-device shard shape of each parameter."""
    runs = {}

    def run(case):
        if case not in runs:
            name, kwargs, vocab, env = CASES[case]
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                jax_reset()
                ad = JAutoDist(strategy_builder=getattr(jstrategy, name)(
                    **kwargs), resource_spec=JResourceSpec(
                        resource_info=worker.STORAGE_SPEC))
                jspec = jax_lm(vocab_size=vocab, **worker.STORAGE_CFG,
                               attn_fn=jax_dense)
                with ad.scope():
                    ad.capture(params=_params(vocab),
                               optimizer=jax_fusable_adam(1e-2),
                               loss_fn=jspec.loss_fn,
                               sparse_vars=jspec.sparse_vars,
                               numerics=NUMERICS)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    jsess = ad.create_distributed_session(mesh=_jax_mesh())
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            batch = _batch(vocab)
            losses = [float(jsess.run(batch)["loss"])
                      for _ in range(worker.STEPS)]
            runs[case] = {
                "losses": losses,
                "eval": float(jsess.evaluate(batch)["loss"]),
                "params": dict(flatten(jax.tree.map(np.asarray,
                                                    jsess.params))),
                "shard": {n: x.sharding.shard_shape(x.shape)
                          for n, x in flatten(jsess.sharded_params)}}
        return runs[case]
    return run


def _stored_plan(case):
    """The port's and the JAX compiler's sets of variables stored 1/N on
    a 4-wide data mesh, from the same Strategy."""
    name, kwargs, vocab, _ = CASES[case]
    params = _params(vocab)
    kw = {"sparse_vars": ("embed",)}
    gi = GraphItem(params_from_jax(params), **kw)
    built = getattr(strategy, name)(**kwargs).build(
        gi, ResourceSpec(resource_info=worker.STORAGE_SPEC))
    port = set(StrategyCompiler(None).compile(built, gi).stored_vars(RANKS))
    jplans = jstrategy.StrategyCompiler(_jax_mesh()).compile(
        jstrategy.Strategy.from_dict(built.to_dict()),
        JGraphItem(params, **kw)).var_plans
    want = {n for n, p in jplans.items()
            if any(e == "data" or (isinstance(e, tuple) and "data" in e)
                   for e in p.param_spec)}
    return port, want


def _stored_buckets(case):
    """The port's stored buckets of ``case`` at data size 4."""
    name, kwargs, vocab, _ = CASES[case]
    gi = GraphItem(params_from_jax(_params(vocab)), sparse_vars=("embed",))
    built = getattr(strategy, name)(**kwargs).build(
        gi, ResourceSpec(resource_info=worker.STORAGE_SPEC))
    return [b for b in plan_step_buckets(
        gi, StrategyCompiler(None).compile(built, gi), RANKS) if b.stored]


def _prefixed(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("case", list(CASES))
def test_stored_variables_are_the_jax_lowerings_sharded_ones(case):
    port, want = _stored_plan(case)
    assert port == want
    assert port, "every case stores something 1/N"


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_a_quarter_of_every_stored_bucket(ranks, jax_run,
                                                          case):
    outs = ranks()
    vocab = CASES[case][2]
    port, _ = _stored_plan(case)
    proxied = "local_proxy_variable" in CASES[case][1]
    logical = dict(flatten(_params(vocab)))
    held = set()
    for r, out in enumerate(outs):
        stored = _prefixed(out, f"{case}/stored/")
        assert bool(stored) != proxied
        for key, (padded, parts, total) in stored.items():
            sz = padded // RANKS
            pad = max(0, (r + 1) * sz - max(total, r * sz))
            assert parts + pad == sz, (key, r)
        for name, shape in _prefixed(out, f"{case}/target/").items():
            assert tuple(shape) == logical[name].shape, name
        assert float(out[f"{case}/flops"]) > 0
        for name, shape in _prefixed(out, f"{case}/shape/").items():
            if f"{case}/part/{name}" in out:
                held.add(name)
                assert len(shape) == 1
            else:
                assert tuple(shape) == logical[name].shape, name
    assert held == (set() if proxied else port)
    if case == "ps_lb":
        # a lone 96-row table: the chunk is JAX's 24-row shard
        shard = jax_run(case)["shard"]["embed"]
        assert shard == (vocab // RANKS, logical["embed"].shape[1])
        for r, out in enumerate(outs):
            part = out[f"{case}/part/embed"]
            assert part.size == np.prod(shard)
            np.testing.assert_array_equal(
                part, out[f"{case}/p/embed"][r * shard[0]:
                                             (r + 1) * shard[0]].reshape(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_four_ranks_train_like_jax_on_four_devices(ranks, jax_run, case):
    outs = ranks()
    want = jax_run(case)
    for out in outs:
        np.testing.assert_allclose(out[f"{case}/losses"], want["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(out[f"{case}/eval"]),
                                   want["eval"], rtol=1e-5)
        got = _prefixed(out, f"{case}/p/")
        assert got.keys() == want["params"].keys()
        for n, x in want["params"].items():
            np.testing.assert_allclose(got[n], x, rtol=0, atol=1e-4,
                                       err_msg=n)
    for key in outs[0]:
        if key.startswith(f"{case}/") and "/part/" not in key \
                and "/shape/" not in key:
            for out in outs[1:]:
                np.testing.assert_array_equal(out[key], outs[0][key],
                                              err_msg=key)


@pytest.mark.parametrize("case", worker.STORAGE_CKPT_CASES)
def test_checkpoint_restores_across_one_and_four_ranks(inputs, ranks, case):
    """Written on 4 ranks after 3 steps, restored on 1; written on 1
    after 2 steps, restored on 4: parameters and moments bit for bit,
    each rank's parts cut from the restored values."""
    tmp, one = inputs
    outs = ranks()
    sess, _ = worker.storage_session(case, _params(CASES[case][2]))
    assert Saver(sess).restore(str(tmp / "ck" / f"{case}_four" /
                                   "step_3")) == 3
    assert not sess.stored_buckets          # one rank holds everything
    here = {}
    worker.storage_state(here, "s", sess)
    for key, x in here.items():
        if key.startswith(("s/p/", "s/o/")):
            np.testing.assert_array_equal(x, outs[0][case + key[1:]],
                                          err_msg=key)
    for r, out in enumerate(outs):
        got = _prefixed(out, f"{case}/from_one/")
        for key, x in one[case].items():
            if key.startswith(("s/p/", "s/o/")):
                np.testing.assert_array_equal(got[key[2:]], x, err_msg=key)
        # the parts are the restored values cut by ``convert``
        want = dict(flatten(params_from_jax(
            {n[4:]: x for n, x in one[case].items() if n.startswith("s/p/")},
            stored_buckets=_stored_buckets(case), rank=r, data=RANKS)))
        parts = _prefixed(got, "part/")
        assert parts
        for name, part in parts.items():
            np.testing.assert_array_equal(part, want[name].numpy(),
                                          err_msg=name)


def test_rollback_restores_the_stored_shards(ranks):
    """``on_nonfinite="rollback"``: two NaN steps restore the verified-good
    step 2 and replay; every rank ends on the clean run's parts, moments
    and parameters, bit for bit."""
    for out in ranks():
        assert out["rollback/rollbacks"].shape == (0, 2)
        assert out["rollback/poisoned/rollbacks"].tolist() == [[4, 2]]
        clean = _prefixed(out, "rollback/")
        drill = _prefixed(out, "rollback/poisoned/")
        assert any(k.startswith("part/") for k in drill)
        for key, x in drill.items():
            if key != "rollbacks":
                np.testing.assert_array_equal(x, clean[key], err_msg=key)
