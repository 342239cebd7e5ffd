"""The port's strategy search and AutoStrategy against the JAX package's
(the slice end to end is ``tests/test_torch_slice_auto.py``).

* ``AutoStrategy`` with ``search=False``, ``True`` and ``"beam"`` (the
  last with and without ``compressor="Int8Compressor"``), at 1, 4 and 8
  chips, on the small LM: both packages give the same Strategy JSON,
  ``last_choice``, evaluated count, the same evaluated candidates with
  their fingerprints and costs, and the same pruned candidates with their
  rule ids.  Both run on the same explicit constants (one
  ``calibration.json`` read by both through ``AUTODIST_CALIBRATION``;
  the port's module constants set to the JAX package's for the
  ``search=True`` ranking) and ``wall_budget_s`` set high, so that
  ``max_evals`` bounds the search;
* the beam search is deterministic, dedupes candidates whose facts were
  priced and ranks by ``(cost, name)``; its genes round-trip through a
  Strategy.
"""
import functools
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import autodist_tpu.strategy as jstrategy
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu.strategy import search as jsearch
from autodist_tpu.telemetry import calibration as jcal
from autodist_tpu_torch import strategy
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import GraphItem
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import cost_model as cm
from autodist_tpu_torch.strategy import search
from autodist_tpu_torch.telemetry import calibration as cal

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

CFG = worker.CFG
#: the constants both packages price with: every leg kind either fitted
#: here or borrowing a fitted kind (``cost_model.FALLBACK_KINDS``)
CALIBRATION = {
    "alphas": {"all_reduce": 2e-5, "reduce_scatter": 1.5e-5,
               "all_gather": 1.2e-5, "ppermute_hop": 6e-6,
               "psum_guard": 8e-6, "update": 2e-6, "fused_update": 1e-6,
               "fused_detect": 1e-6},
    "bandwidths": {"all_reduce": 2e10, "reduce_scatter": 3e10,
                   "all_gather": 3.5e10, "ppermute_hop": 2.5e10,
                   "psum_guard": 1e9, "update": 4e11, "fused_update": 6e11,
                   "fused_detect": 8e11},
    "quant_overhead_per_byte": 1e-12, "scale": 1.1,
    "ici_bandwidth": 2.5e10, "alpha": 1.5e-5}
SEARCHES = {"False": (False, "NoneCompressor"), "True": (True,
                                                         "NoneCompressor"),
            "beam": ("beam", "NoneCompressor"),
            "beam-int8": ("beam", "Int8Compressor")}
BIG_WALL_BUDGET = 1e9


@pytest.fixture(autouse=True)
def same_constants(monkeypatch, tmp_path):
    """One calibration for both packages; the port's module constants
    the JAX package's; the wall-clock budget out of the way."""
    torch.set_num_threads(1)
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps(CALIBRATION))
    monkeypatch.setenv("AUTODIST_CALIBRATION", str(path))
    monkeypatch.delenv("AUTODIST_TELEMETRY_DIR", raising=False)
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()
    for name in ("ICI_BANDWIDTH", "DCN_BANDWIDTH", "COLLECTIVE_ALPHA",
                 "HBM_BANDWIDTH"):
        monkeypatch.setattr(cm, name, getattr(jcm, name))
    for mod in (search, jsearch):
        monkeypatch.setattr(mod, "SearchSpace", functools.partial(
            mod.SearchSpace, wall_budget_s=BIG_WALL_BUDGET))
    yield
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()


def _jax_params():
    return jax.tree.map(np.asarray, jax_lm(**CFG).init(
        jax.random.PRNGKey(0)))


def _graph_items(params):
    jspec = jax_lm(**CFG)
    kw = dict(sparse_vars=jspec.sparse_vars, numerics={"clip_norm": 1.0})
    return (JGraphItem(params, optimizer=jax_fusable_adam(1e-3), **kw),
            GraphItem(params_from_jax(params), optimizer=fusable_adam(1e-3),
                      **kw))


def _candidates(result):
    return [(e.name, e.fingerprint, e.cost_s, e.num_collectives,
             e.exposed_wire_bytes) for e in result.evaluated]


@pytest.mark.parametrize("chips", [1, 4, 8])
@pytest.mark.parametrize("mode", sorted(SEARCHES))
def test_auto_strategy_chooses_as_the_jax_package(mode, chips):
    search_arg, comp = SEARCHES[mode]
    jgi, pgi = _graph_items(_jax_params())
    info = {"nodes": [{"address": "localhost", "chips": chips}],
            "hbm_gb": 80}
    jb = jstrategy.AutoStrategy(search=search_arg, compressor=comp)
    pb = strategy.AutoStrategy(search=search_arg, compressor=comp)
    want = jb.build(jgi, JResourceSpec(resource_info=info))
    got = pb.build(pgi, ResourceSpec(resource_info=info))
    assert got.to_dict()["node_config"] == want.to_dict()["node_config"]
    # the replica lists name the chips: GPU here, TPU there
    assert got.to_dict()["graph_config"] == {**want.to_dict()[
        "graph_config"], "replicas": [r.replace(":TPU:", ":GPU:") for r in
                                      want.to_dict()["graph_config"][
                                          "replicas"]]}
    assert pb.last_choice == jb.last_choice
    if search_arg != "beam":
        return
    jr, pr = jb.last_search, pb.last_search
    assert pr.calibrated and jr.calibrated
    assert (pr.n_evals, pr.rounds, len(pr.evaluated)) == \
        (jr.n_evals, jr.rounds, len(jr.evaluated))
    assert pr.n_evals < search.SearchSpace().max_evals or \
        pr.n_evals == jr.n_evals
    got_c, want_c = _candidates(pr), _candidates(jr)
    assert [c[:2] + c[3:] for c in got_c] == [c[:2] + c[3:] for c in want_c]
    for a, b in zip(got_c, want_c):
        assert a[2] == pytest.approx(b[2], rel=1e-12)
    assert [(p.name, p.pruned_by) for p in pr.pruned] == \
        [(p.name, p.pruned_by) for p in jr.pruned]
    assert pr.best.fingerprint == jr.best.fingerprint


def test_beam_search_dedupes_and_breaks_ties_by_cost_then_name():
    jgi, pgi = _graph_items(_jax_params())
    info = {"nodes": [{"address": "localhost", "chips": 4}]}
    result = search.beam_search(pgi, ResourceSpec(resource_info=info))
    # a candidate whose facts were priced already is not priced again
    assert len(result.evaluated) + len(result.pruned) < result.n_evals
    ranked = result.top(len(result.evaluated))
    assert ranked[0] is result.best
    assert [(e.cost_s, e.name) for e in ranked] == sorted(
        (e.cost_s, e.name) for e in result.evaluated)
    again = search.beam_search(pgi, ResourceSpec(resource_info=info))
    assert _candidates(again) == _candidates(result)
    genes = search.genes_from_strategy(result.best_strategy, pgi)
    back = search.strategy_from_genes(genes, pgi,
                                      ResourceSpec(resource_info=info))
    assert back.to_dict()["node_config"] == \
        result.best_strategy.to_dict()["node_config"]
