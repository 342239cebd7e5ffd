"""The port's PS family and partitioned all-reduce builders against the
JAX package.

* the Strategy JSON of all seven builders on two catalogs (the small
  ``transformer_lm`` and the case matrix's sparse model) and two resource
  specs, and ``partition_utils`` function by function;
* the compiler: PS nodes lower to reduce-scatter (weight-update sharding)
  plans whose PS fields match the JAX compiler's on a data-only mesh;
  staleness and proxy variables train against the JAX session;
  ``sync=False`` trains;
* the small LM under ``PSLoadBalancing``, ``PartitionedPS``,
  ``UnevenPartitionedPS``, ``Parallax`` and ``PartitionedAR`` with
  ``fusable_adam`` and clip, on one CPU rank and on two gloo ranks,
  against the JAX session on its 8-device CPU mesh from the same weights:
  losses and global norms at rtol 1e-5, parameters at atol 1e-4, Adam
  moments per variable at atol 1e-6 (the tolerances of
  ``tests/test_torch_zero1.py``); under PS each rank holds 1/N of every
  reduce-scatter bucket's moments; a JAX PS state continues in the port;
* the case-matrix twin (``tests/test_case_matrix.py``: cases ``sparse``,
  ``scan``, ``while_loop``, ``dynamic_lstm`` × all 8 builders) on two
  gloo ranks and on four as ``{"data": 2, "model": 2}`` (its ``dp4tp2``
  cells), and the reference-variant twin on ``scan``, held to that
  test's JAX single-device loop at its rtol 1e-4.

Every multi-rank run is one launch of a gloo worker pair
(``tests/torch_dp_worker.py``, mode ``ps``).
"""
import json
import random
import sys
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
from autodist_tpu.graph_item import VarInfo as JVarInfo
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import partition_utils as jpu
from autodist_tpu_torch import strategy
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy, sync_state_from_jax)
from autodist_tpu_torch.graph_item import GraphItem, VarInfo, flatten
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    pack_bucket, unpack_bucket)
from autodist_tpu_torch.kernel.synchronization.explicit_sync import \
    plan_step_buckets
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import StrategyCompiler, parse_partitioner
from autodist_tpu_torch.strategy import partition_utils as pu

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_case_matrix as jcm  # noqa: E402  (the JAX case matrix)
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

CFG = worker.CFG
BUILDERS = ("PS", "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
            "Parallax", "PartitionedAR", "RandomAxisPartitionAR")
SPECS = {
    "one_node": {"nodes": [{"address": "localhost", "chips": 1,
                            "chief": True}]},
    "two_nodes": {"nodes": [
        {"address": "10.0.0.1", "chips": 2, "cpus": [0], "chief": True},
        {"address": "10.0.0.2", "chips": 2, "cpus": [0, 1]}]},
}
NUMERICS = {"clip_norm": worker.CLIP}
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
STEPS = 5


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")


@pytest.fixture(scope="module")
def params0():
    """The worker's initial weights (the port's init from seed 0) as
    numpy, the tree both packages start from."""
    return params_to_numpy(transformer_lm(**CFG).init(0, device="cpu"))


def _batch():
    """The worker's fixed global batch of 8 rows."""
    return transformer_lm(**CFG).sample_batch(8, seed=1)


def _case(case):
    """``(params as numpy, loss_fn, batch, capture kwargs, rtol)`` of the
    JAX case matrix's ``case``."""
    params, loss_fn, batch, kw, rtol = jcm.CASES[case]()
    return jax.tree.map(np.asarray, params), loss_fn, batch, kw, rtol


def _catalog(name, params0):
    if name == "lm":
        return params0, {"sparse_vars": ("embed",)}
    params, _, _, kw, _ = _case("sparse")
    return params, kw


def _jax_to_port_json(strategy_dict):
    """The JAX Strategy's JSON with the accelerator named as the port
    names it (``GPU``, not ``TPU``)."""
    return json.loads(json.dumps(strategy_dict).replace(":TPU:", ":GPU:"))


def _build_both(name, params, kw, spec, **args):
    want = getattr(jstrategy, name)(**args).build(
        JGraphItem(params, **kw), JResourceSpec(resource_info=SPECS[spec]))
    got = getattr(strategy, name)(**args).build(
        GraphItem(params_from_jax(params), **kw),
        ResourceSpec(resource_info=SPECS[spec]))
    want.id = got.id = "pinned"
    return got.to_dict(), _jax_to_port_json(want.to_dict())


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("catalog", ["lm", "sparse"])
@pytest.mark.parametrize("name", BUILDERS)
def test_strategy_json_matches_jax(params0, name, catalog, spec):
    params, kw = _catalog(catalog, params0)
    got, want = _build_both(name, params, kw, spec)
    assert got == want
    assert len(got["node_config"]) == len(flatten(params))


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_random_axis_partition_picks_jax_axes(params0, seed):
    """The seeded ``random.Random`` picks the same axis, variable by
    variable, in both packages."""
    got, want = _build_both("RandomAxisPartitionAR", params0,
                            {"sparse_vars": ("embed",)}, "two_nodes",
                            seed=seed)
    assert got == want
    axes = {parse_partitioner(n["partitioner"])[0]
            for n in got["node_config"]}
    assert axes - {None, 0}, "no variable split along another axis"


def test_builders_refuse_what_jax_refuses():
    for name in ("Parallax", "PartitionedAR", "RandomAxisPartitionAR"):
        for module in (jstrategy, strategy):
            with pytest.raises(ValueError):
                getattr(module, name)(chunk_size=0)


@pytest.mark.parametrize("fn", ["smallest_divisor_gt_one",
                                "first_non_divisor"])
def test_divisor_rules_match_jax(fn):
    for n in range(-2, 513):
        assert getattr(pu, fn)(n) == getattr(jpu, fn)(n), n


def test_partition_str_and_partitionable_match_jax():
    for shape in [(), (1,), (7,), (1, 5), (4, 1, 3), (97, 16), (2, 2, 2)]:
        for axis in range(max(len(shape), 1) + 1):
            jv = JVarInfo("v", shape, "float32")
            v = VarInfo("v", shape, "float32")
            assert pu.partitionable(v, axis) == jpu.partitionable(jv, axis)
            if axis < len(shape):
                for n in (1, 2, 5):
                    assert pu.partition_str(shape, axis, n) == \
                        jpu.partition_str(shape, axis, n)


@pytest.mark.parametrize("bins", [1, 2, 3, 8])
def test_greedy_load_balance_matches_jax(bins):
    rng = random.Random(bins)
    for _ in range(50):
        sizes = [rng.choice([0, 4, 64, 1024, rng.randint(1, 1 << 20),
                             rng.random() * 100])
                 for _ in range(rng.randint(0, 40))]
        assert pu.greedy_load_balance(sizes, bins) == \
            jpu.greedy_load_balance(sizes, bins)


def test_byte_size_and_cpu_devices_match_jax(params0):
    jgi, gi = JGraphItem(params0), GraphItem(params_from_jax(params0))
    assert [v.byte_size for v in gi.trainable_var_infos] == \
        [v.byte_size for v in jgi.trainable_var_infos]
    assert VarInfo("b", (3, 5), "bfloat16").byte_size == 30
    for spec in SPECS.values():
        assert [d.name_string() for d in
                ResourceSpec(resource_info=spec).cpu_devices] == \
            [d.name_string() for d in
             JResourceSpec(resource_info=spec).cpu_devices]


def test_ps_nodes_lower_to_reduce_scatter_plans(params0):
    """Every PS node is a weight-update-sharding plan (``reduce_scatter``,
    no compressor, the default bucket cap) whose destination, partition
    axis, shard count and sparse flag are the JAX compiler's on its
    8-device data mesh; AllReduce nodes stay ``all_reduce`` plans."""
    kw = {"sparse_vars": ("embed",)}
    gi, jgi = GraphItem(params_from_jax(params0), **kw), \
        JGraphItem(params0, **kw)
    jmesh = jax_build_mesh({"data": 8})
    for name in BUILDERS:
        built = getattr(strategy, name)().build(
            gi, ResourceSpec(resource_info=SPECS["two_nodes"]))
        plans = StrategyCompiler(None).compile(built, gi).var_plans
        jplans = jstrategy.StrategyCompiler(jmesh).compile(
            jstrategy.Strategy.from_dict(built.to_dict()), jgi).var_plans
        assert plans.keys() == jplans.keys()
        for var, plan in plans.items():
            want = jplans[var]
            assert plan.sync_kind == want.sync_kind, (name, var)
            if plan.sync_kind == "AllReduce":
                assert plan.sync_mode == "all_reduce"
                continue
            assert (plan.sync_mode, plan.compressor, plan.bucket_bytes) == \
                ("reduce_scatter", "NoneCompressor", 0)
            assert (plan.reduction_destination, plan.partition_axis,
                    plan.num_shards, plan.sparse) == \
                (want.reduction_destination, want.partition_axis,
                 want.num_shards, want.sparse), (name, var)
            assert built.node_for(var).synchronizer.reduction_destination \
                == plan.reduction_destination
        kinds = {p.sync_kind for p in plans.values()}
        assert kinds == ({"AllReduce", "PS"} if name == "Parallax" else
                         {"AllReduce"} if name.endswith("AR") else {"PS"})


def _port_session(params, builder, opt=None, numerics=NUMERICS):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=opt or fusable_adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    return ad.create_distributed_session()


@pytest.mark.parametrize("name,kwargs", [
    ("PSLoadBalancing", {"staleness": 2}), ("PS", {"staleness": 1}),
    ("PartitionedPS", {"local_proxy_variable": True}),
    ("Parallax", {"local_proxy_variable": True})],
    ids=["ps_lb_staleness", "ps_staleness", "partitioned_proxy",
         "parallax_proxy"])
def test_staleness_and_proxy_variables_raise_naming_p6(params0, name,
                                                      kwargs, monkeypatch):
    """Once refused naming P6, staleness and proxy variables (refreshed
    every 2 steps) train now: 4 steps against the JAX session of the same
    builder on its 8-device mesh, losses at rtol 1e-5 and parameters at
    atol 1e-4.  Both packages turn the guard off under a stale or proxy
    step, so no ``grad_health`` comes back."""
    import warnings

    monkeypatch.setenv("AUTODIST_PROXY_REFRESH", "2")
    batch = _batch()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the guard's drop, adam's update
        sess = _port_session(params0, getattr(strategy, name)(**kwargs))
    jax_reset()
    ad = JAutoDist(strategy_builder=getattr(jstrategy, name)(**kwargs))
    jspec = jax_lm(**CFG, attn_fn=jax_dense)
    with ad.scope():
        ad.capture(params=params0, optimizer=jax_fusable_adam(1e-2),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars,
                   numerics=NUMERICS)
    jsess = ad.create_distributed_session()
    assert "step" in sess.sync_state     # the stale state is on
    for _ in range(4):
        got, want = sess.run(batch), jsess.run(batch)
        assert "grad_health" not in got and "grad_health" not in want
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-5)
    _assert_params_close(sess.params, jax.tree.map(np.asarray,
                                                   jsess.params))


def test_sync_false_trains_bulk_synchronously(params0):
    """``sync=False`` is carried in the Strategy and the step stays
    bulk-synchronous, as in the JAX package: the same losses, bit for
    bit, as ``sync=True``."""
    batch = _batch()
    runs = []
    for sync in (False, True):
        sess = _port_session(params0, strategy.PSLoadBalancing(sync=sync))
        runs.append([float(sess.run(batch)["loss"]) for _ in range(3)])
    assert runs[0] == runs[1]


def _per_variable(opt, buckets):
    """``{"mu"|"nu": {variable: array}}`` of an optimizer state in the
    session's layout (reduce-scatter buckets unpacked)."""
    if "zero1" not in opt:
        return {m: {n: x.numpy() for n, x in flatten(opt[m])}
                for m in ("mu", "nu")}
    by_key = {b.key: b for b in buckets}
    out = {}
    for m in ("mu", "nu"):
        leaves = {n: x.numpy() for n, x in flatten(opt["vars"][m])}
        for key, vec in opt["zero1"][m].items():
            leaves.update((n, x.numpy()) for n, x in
                          zip(by_key[key].names,
                              unpack_bucket(by_key[key], vec)))
        out[m] = leaves
    return out


def _jax_moments(jopt):
    return {m: {n: x.numpy() for n, x in flatten(v)}
            for m, v in opt_state_from_jax(jopt).items() if m != "count"}


@pytest.fixture(scope="module")
def jax_run(params0):
    """``jax_run(name)``: :func:`_jax_session_run` of builder ``name``,
    computed once per module."""
    runs = {}

    def run(name):
        if name not in runs:
            runs[name] = _jax_session_run(params0, name)
        return runs[name]
    return run


def _jax_session_run(params0, name):
    """The JAX session of builder ``name`` on the 8-device mesh, from the
    same weights, with ``fusable_adam(1e-2)`` and clip: 5 steps' losses and
    norms, and its state after 2, 3 and 5 steps."""
    jax_reset()
    ad = JAutoDist(strategy_builder=getattr(jstrategy, name)())
    jspec = jax_lm(**CFG, attn_fn=jax_dense)
    with ad.scope():
        ad.capture(params=params0, optimizer=jax_fusable_adam(1e-2),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars,
                   numerics=NUMERICS)
    jsess = ad.create_distributed_session()
    assert jsess.mesh.shape["data"] == 8
    batch = _batch()
    run = {"losses": [], "norms": [], "state": {}}
    for step in range(1, STEPS + 1):
        out = jsess.run(batch)
        run["losses"].append(float(out["loss"]))
        run["norms"].append(float(out["grad_health"].global_norm))
        if step in (2, 3, 5):
            run["state"][step] = (
                jax.tree.map(np.asarray, jsess.export_state()),
                jax.tree.map(np.asarray, jsess.sync_state))
    return run


def _assert_params_close(got, want, atol=1e-4):
    got, want = dict(flatten(got)), dict(flatten(want))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), rtol=0,
                                   atol=atol, err_msg=name)


def _assert_moments_close(got, want, atol=1e-6):
    for m in ("mu", "nu"):
        assert got[m].keys() == want[m].keys()
        for n in want[m]:
            np.testing.assert_allclose(got[m][n], want[m][n], rtol=0,
                                       atol=atol, err_msg=f"{m} {n}")


@pytest.mark.parametrize("name", worker.PS_LM_BUILDERS)
def test_one_rank_trains_like_jax(params0, jax_run, name):
    """5 steps on one CPU rank against the JAX 8-device session: losses and
    global norms at rtol 1e-5, parameters at atol 1e-4, every variable's
    Adam moments at atol 1e-6.  PS plans run the bucketed step with K5's
    plain version; ``PartitionedAR`` the all-reduce step."""
    want = jax_run(name)
    sess = _port_session(params0, getattr(strategy, name)())
    ps = name != "PartitionedAR"
    assert sess._step.fused_kernels == (("guard", "update") if ps else ())
    assert bool(sess.zero1_buckets) == ps
    batch = _batch()
    outs = [sess.run(batch) for _ in range(STEPS)]
    np.testing.assert_allclose([float(o["loss"]) for o in outs],
                               want["losses"], rtol=1e-5)
    np.testing.assert_allclose(
        [float(o["grad_health"].global_norm) for o in outs], want["norms"],
        rtol=1e-5)
    (jparams, jopt), _ = want["state"][5]
    _assert_params_close(sess.params, jparams)
    _, exported = sess.export_state()
    _assert_moments_close(_per_variable(exported, sess.zero1_buckets),
                          _jax_moments(jopt))


@pytest.mark.parametrize("name", ["PSLoadBalancing", "Parallax"])
def test_jax_ps_state_continues_in_the_port(params0, jax_run, name):
    """The JAX PS session's state after 2 steps (per-variable moments, as
    its GSPMD step holds them), packed into the port's reduce-scatter
    buckets, continues as JAX does; sliced for 2 ranks, the shards
    reassemble the packed vectors."""
    want = jax_run(name)
    (jparams, jopt), jsync = want["state"][2]
    sess = _port_session(params0, getattr(strategy, name)())
    sess.import_state(params_from_jax(jparams),
                      opt_state_from_jax(jopt,
                                         zero1_buckets=sess.zero1_buckets),
                      step=2, sync_state=sync_state_from_jax(jsync))
    assert int(sess.opt_state["zero1"]["count"]) == 2
    batch = _batch()
    np.testing.assert_allclose(
        [float(sess.run(batch)["loss"]) for _ in range(3)],
        want["losses"][2:], rtol=1e-5)
    _assert_params_close(sess.params, want["state"][5][0][0])

    plan = _plan(params0, name, 2)
    full = opt_state_from_jax(jopt, zero1_buckets=plan)["zero1"]
    halves = [opt_state_from_jax(jopt, zero1_buckets=plan, rank=r, data=2)
              for r in range(2)]
    for b in plan:
        for m in ("mu", "nu"):
            torch.testing.assert_close(
                torch.cat([h["zero1"][m][b.key] for h in halves]),
                full[m][b.key], rtol=0, atol=0)
            leaves = dict(flatten(opt_state_from_jax(jopt)[m]))
            torch.testing.assert_close(
                full[m][b.key], pack_bucket(b, [leaves[n] for n in b.names]),
                rtol=0, atol=0)


def _plan(params0, name, d):
    """The reduce-scatter buckets of builder ``name`` at data size ``d``."""
    gi = GraphItem(params_from_jax(params0), sparse_vars=("embed",))
    built = getattr(strategy, name)().build(
        gi, ResourceSpec(resource_info=SPECS["one_node"]))
    return [b for b in plan_step_buckets(
        gi, StrategyCompiler(None).compile(built, gi), d)
        if b.mode == "reduce_scatter"]


@pytest.fixture(scope="module")
def case_data(tmp_path_factory):
    """The JAX case matrix's parameters and batches, as the worker reads
    them (``{case}/p/{name}``, ``{case}/b/{key}``): the npz path."""
    path = tmp_path_factory.mktemp("ps_family") / "cases.npz"
    data = {}
    def entry(key, x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":      # numpy's files lack the dtype
            return f"{key}:bfloat16", x.view(np.uint16)
        return key, x

    for case in worker.CASES:
        params, _, batch, _, _ = _case(case)
        data.update(entry(f"{case}/p/{n}", x) for n, x in flatten(params))
        data.update(entry(f"{case}/b/{k}", x) for k, x in batch.items())
    np.savez(path, **data)
    return path


@pytest.fixture(scope="module")
def gloo(case_data):
    """One launch of a 2-rank gloo worker pair in ``ps`` mode: both
    ranks' outputs."""
    tmp = case_data.parent
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init, tmp / f"rank{rank}.npz",
                            "ps", case_data],
        world=2, tmp_dir=tmp, timeout=240)
    return [np.load(tmp / f"rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("name", worker.PS_LM_BUILDERS)
def test_two_gloo_ranks_shard_the_moments_and_match_jax(params0, jax_run,
                                                         gloo, name):
    """On 2 gloo ranks: losses and norms of 3 steps at rtol 1e-5 of the
    JAX 8-device session's, parameters at atol 1e-4; under PS each rank
    holds ``padded_total / 2`` of every bucket's moments, and the logical
    moments (gathered by ``export_state``, the same on both ranks) match
    JAX's per variable at atol 1e-6."""
    want = jax_run(name)
    (jparams, jopt), _ = want["state"][3]
    plan = _plan(params0, name, 2)
    assert bool(plan) == (name != "PartitionedAR")
    for out in gloo:
        np.testing.assert_allclose(out[f"lm/{name}/losses"],
                                   want["losses"][:3], rtol=1e-5)
        np.testing.assert_allclose(out[f"lm/{name}/norms"],
                                   want["norms"][:3], rtol=1e-5)
        prefix = f"lm/{name}/p:"
        _assert_params_close({k[len(prefix):]: out[k] for k in out.files
                              if k.startswith(prefix)},
                             dict(flatten(jparams)))
        for b in plan:
            assert int(out[f"lm/{name}/shard:{b.key}"]) == b.padded_total // 2
        if plan:
            exported = {"vars": {"mu": {}, "nu": {}}, "zero1": {
                m: {b.key: torch.from_numpy(out[f"lm/{name}/full_{m}:"
                                                f"{b.key}"])
                    for b in plan} for m in ("mu", "nu")}}
            got = _per_variable(exported, plan)
            want_m = _jax_moments(jopt)
            _assert_moments_close(
                got, {m: {n: want_m[m][n] for n in got[m]}
                      for m in ("mu", "nu")})
    for key in gloo[0].files:
        if "/full_" in key:
            np.testing.assert_array_equal(gloo[0][key], gloo[1][key])


@pytest.fixture(scope="module")
def single_device_losses():
    """``single_device_losses(case)``: the JAX case matrix's
    single-device loop on ``case`` and the case's tolerance, computed once
    per module."""
    losses = {}

    def get(case):
        if case not in losses:
            params, loss_fn, batch, kw, rtol = jcm.CASES[case]()
            losses[case] = (jcm._single_device_losses(params, loss_fn,
                                                      batch, kw), rtol)
        return losses[case]
    return get


@pytest.mark.parametrize("name", worker.CASE_BUILDERS)
@pytest.mark.parametrize("case", worker.CASES)
def test_case_matrix_on_two_gloo_ranks(gloo, single_device_losses, case,
                                       name):
    """The twin of ``tests/test_case_matrix.py``'s data-parallel cells:
    3 ``adam(1e-2)`` steps on 2 gloo ranks at the case's tolerance of the
    JAX single-device loop (rtol 1e-4; 2e-2 for ``bf16_remat``, bf16
    parameters and batch under ``remat="dots"``)."""
    want, rtol = single_device_losses(case)
    for out in gloo:
        np.testing.assert_allclose(out[f"case/{case}/{name}"], want,
                                   rtol=rtol)


@pytest.fixture(scope="module")
def gloo_model(case_data):
    """One launch of 4 gloo ranks in ``ps_model`` mode: every rank's
    outputs."""
    tmp = case_data.parent
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 4, init,
                            tmp / f"model{rank}.npz", "ps_model", case_data],
        world=4, tmp_dir=tmp, timeout=300)
    return [np.load(tmp / f"model{r}.npz") for r in range(4)]


@pytest.mark.parametrize("name", worker.CASE_BUILDERS)
@pytest.mark.parametrize("case", worker.CASES)
def test_case_matrix_on_a_data_model_mesh(gloo_model, single_device_losses,
                                          case, name):
    """The twin of ``tests/test_case_matrix.py``'s ``dp4tp2`` cells on 4
    gloo ranks as ``{"data": 2, "model": 2}``: the partitioners shard
    over ``model`` (a padded partition is replicated), 3 ``adam(1e-2)``
    steps at the case's tolerance of the JAX single-device loop."""
    want, rtol = single_device_losses(case)
    for out in gloo_model:
        np.testing.assert_allclose(out[f"case/{case}/{name}"], want,
                                   rtol=rtol)


@pytest.mark.parametrize("index", range(len(worker.REFERENCE_VARIANTS)))
def test_reference_variants_on_scan(request, single_device_losses, index):
    """The twin of ``test_reference_strategy_variant_matrix``: every
    variant trains on 2 gloo ranks, held to the JAX single-device loop at
    rtol 5e-2 for the bf16-wire compressors (that test's tolerance for
    them) and 1e-4 for the others: the proxy variables too, which at
    ``AUTODIST_PROXY_REFRESH=1`` take the plain step."""
    builder = worker.REFERENCE_VARIANTS[index]()
    bf16_wire = getattr(builder, "_compressor", "") in (
        "HorovodCompressor", "HorovodCompressorEF")
    rtol = 5e-2 if bf16_wire else 1e-4
    for out in request.getfixturevalue("gloo"):
        np.testing.assert_allclose(out[f"variant/{index}"],
                                   single_device_losses("scan")[0],
                                   rtol=rtol)
