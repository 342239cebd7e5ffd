"""The port's what-if simulator (``autodist_tpu_torch/analysis/
simulate.py``) and the analyzer's CLI (``python -m
autodist_tpu_torch.analysis``) against the JAX package's
(``tests/test_analysis_cli.py``, ``tests/test_search.py:178``,
``tests/test_dataflow.py:531``).

* the sweep's spec parser, the preemption goodput model and the whole
  sweep report (every point, mode, fingerprint, price, watermark and
  pruning rule) equal the JAX package's for the same catalog, builder
  and constants, and so does its rendering (but the wall-clock line);
* the CLI's exit codes and output match the JAX CLI's: a non-divisible
  partition exits 1 with ``legality/indivisible-partition``, the demo
  catalogs under every builder exit 0 with the same table (the pipeline
  and expert catalogs on their own meshes too), a budget
  exceeded exits 1, ``--dump-ir``, ``--watermark``, ``--search-report``,
  ``--simulate``, ``--list-models`` and ``--list-rules``; the verdict is
  checked, not the wall clock; ``--elastic-from`` runs the elastic rules.
"""
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import pytest
import torch

from autodist_tpu.analysis import simulate as jsim
from autodist_tpu.analysis.__main__ import main as jmain
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.strategy.base import PSSynchronizerConfig as JPS
from autodist_tpu.strategy.base import Strategy as JStrategy
from autodist_tpu.strategy.base import VarConfig as JVarConfig
from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu_torch.analysis import simulate as sim
from autodist_tpu_torch.analysis.__main__ import main
from autodist_tpu_torch.strategy import cost_model as cm
from autodist_tpu_torch.telemetry import calibration as cal
from autodist_tpu.telemetry import calibration as jcal

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def same_constants(monkeypatch):
    """Both packages price with the JAX package's default constants (the
    CLI builds its estimates with the keyword defaults, so those are set
    too) and no calibration file."""
    torch.set_num_threads(1)
    monkeypatch.delenv("AUTODIST_CALIBRATION", raising=False)
    monkeypatch.delenv("AUTODIST_TELEMETRY_DIR", raising=False)
    for mod in (cal, jcal):
        mod.reset_calibration_cache_for_testing()
    for name in ("ICI_BANDWIDTH", "DCN_BANDWIDTH", "COLLECTIVE_ALPHA",
                 "HBM_BANDWIDTH"):
        monkeypatch.setattr(cm, name, getattr(jcm, name))
    for fn in ("estimate_ir_cost", "leg_cost_s"):
        port, ref = getattr(cm, fn), getattr(jcm, fn)
        monkeypatch.setattr(port, "__kwdefaults__",
                            dict(port.__kwdefaults__ or {},
                                 **{k: v for k, v in
                                    (ref.__kwdefaults__ or {}).items()
                                    if k in (port.__kwdefaults__ or {})}))


def _run(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def _no_clock(text):
    return re.sub(r"in \d+\.\d+ s", "in - s", text)


def _no_wall(report):
    return dict(report, wall_time_s=None)


@pytest.mark.parametrize("spec", [
    "mesh=data=8;slices=1,2",
    "mesh=data=16;slices=1,2,4;dcn=12.5,100;hbm=16",
    "mesh=data=8;slices=3",
    "mesh=data=8;stages=1,2;mb=4;act=2",
])
def test_sweep_report_equals_the_jax_package(spec):
    assert sim.parse_sweep_spec(spec) == jsim.parse_sweep_spec(spec)
    for builder in ("AllReduce", "Zero1"):
        rc, out = _run(main, ["mlp", builder, "--simulate", spec, "--json"])
        jrc, jout = _run(jmain, ["mlp", builder, "--simulate", spec,
                                 "--json"])
        assert rc == jrc
        assert _no_wall(json.loads(out)) == _no_wall(json.loads(jout))
        rc, out = _run(main, ["mlp", builder, "--simulate", spec])
        jrc, jout = _run(jmain, ["mlp", builder, "--simulate", spec])
        assert _no_clock(out) == _no_clock(jout)


def test_sweep_parser_and_goodput_model():
    for bad in ("mesh", "slices=1,2", "frob=1;mesh=data=8"):
        with pytest.raises(ValueError) as err:
            sim.parse_sweep_spec(bad)
        with pytest.raises(ValueError) as jerr:
            jsim.parse_sweep_spec(bad)
        assert str(err.value) == str(jerr.value)
    for step_s in (1e-3, 0.25, 7.0):
        assert sim.goodput_under_preemption(step_s) == \
            jsim.goodput_under_preemption(step_s)
    spec = sim._fabricated_spec({"data": 16}, 2, 25.0, 16.0)
    assert spec.num_slices == 2 and spec.hbm_bytes_per_chip == 16 << 30


def test_cli_rejects_illegal_strategy(tmp_path):
    """Exit 1 and the rule id for a non-divisible partition on an 8-chip
    mesh, as the JAX CLI (the verdict, not the clock: the port's twin of
    ``test_cli_rejects_illegal_strategy_fast``)."""
    gi = JGraphItem({"w": jax.ShapeDtypeStruct((3, 4), jnp.float32),
                     "b": jax.ShapeDtypeStruct((4,), jnp.float32)})
    strategy = JStrategy(node_config=[
        JVarConfig("w", synchronizer=JPS(), partitioner="3,1"),
        JVarConfig("b", synchronizer=JPS())])
    spath = tmp_path / "strategy.json"
    spath.write_text(json.dumps(strategy.to_dict()))
    cpath = tmp_path / "catalog.json"
    cpath.write_text(gi.serialize())
    r = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.analysis", str(cpath),
         str(spath), "--mesh", "data=8"], capture_output=True, text=True,
        timeout=240, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "legality/indivisible-partition" in r.stdout
    jrc, jout = _run(jmain, [str(cpath), str(spath), "--mesh", "data=8"])
    assert jrc == 1 and r.stdout == jout


@pytest.mark.parametrize("model", ["linear_regression", "mlp", "mlp_bf16",
                                   "embedding_lm"])
def test_cli_every_builder_on_every_demo_model(model):
    for builder in ("AllReduce", "PS", "PSLoadBalancing", "PartitionedPS",
                    "Parallax", "AutoStrategy"):
        rc, out = _run(main, [model, builder, "--mesh", "data=8"])
        jrc, jout = _run(jmain, [model, builder, "--mesh", "data=8"])
        assert rc == jrc == 0, (model, builder)
        assert out == jout, (model, builder)


@pytest.mark.parametrize("model,mesh", [("pipeline", "pipe=4,data=2"),
                                        ("moe", "data=8")])
def test_cli_pipeline_and_expert_catalogs_name_p10(model, mesh):
    """The pipeline and expert catalogs analyze with the JAX CLI's exit
    code and output: the pipeline catalog on a pipe mesh and a data mesh,
    the expert catalog on a data mesh and an expert mesh, under three
    builders."""
    other = "data=8" if model == "pipeline" else "data=4,expert=2"
    for m in (mesh, other):
        for builder in ("AllReduce", "PSLoadBalancing", "Parallax"):
            rc, out = _run(main, [model, builder, "--mesh", m])
            jrc, jout = _run(jmain, [model, builder, "--mesh", m])
            assert rc == jrc == 0 and out == jout, (m, builder)


def test_cli_json_output_and_budget():
    rc, out = _run(main, ["mlp", "AllReduce", "--mesh", "data=8", "--json",
                          "--budget-gb", "0.000001"])
    jrc, jout = _run(jmain, ["mlp", "AllReduce", "--mesh", "data=8",
                             "--json", "--budget-gb", "0.000001"])
    assert rc == jrc == 1
    got = json.loads(out)
    assert any(d["rule"] == "memory/watermark-exceeds-hbm"
               for d in got["diagnostics"])
    assert [d["rule"] for d in got["diagnostics"]] == [
        d["rule"] for d in json.loads(jout)["diagnostics"]]
    assert _run(main, ["mlp_bf16", "AllReduce", "--mesh", "data=8",
                       "--warn-as-error"])[0] == _run(
        jmain, ["mlp_bf16", "AllReduce", "--mesh", "data=8",
                "--warn-as-error"])[0]


def test_cli_watermark_and_dump_ir():
    """The JAX package's ``test_dataflow.py:531``: a budget the watermark
    exceeds exits 1 with ``EXCEEDED``; ``--watermark --json`` exits 0;
    ``--dump-ir json`` with ``--watermark`` gives both objects, the IR
    equal to the JAX CLI's; ``--dump-ir dot`` a Graphviz graph."""
    rc, out = _run(main, ["mlp", "Zero1", "--mesh", "data=8", "--watermark",
                          "--budget-gb", "0.000001"])
    assert rc == 1 and "EXCEEDED" in out
    assert out == _run(jmain, ["mlp", "Zero1", "--mesh", "data=8",
                               "--watermark", "--budget-gb", "0.000001"])[1]
    rc, out = _run(main, ["mlp", "Zero1", "--mesh", "data=8", "--watermark",
                          "--json"])
    assert rc == 0 and json.loads(out)["peak_bytes"] > 0
    rc, out = _run(main, ["mlp", "Zero1", "--mesh", "data=8", "--watermark",
                          "--dump-ir", "json"])
    _, jout = _run(jmain, ["mlp", "Zero1", "--mesh", "data=8", "--watermark",
                           "--dump-ir", "json"])
    payload, jpayload = json.loads(out), json.loads(jout)
    assert rc == 0 and payload["schedule_ir"]["legs"]
    assert payload["schedule_ir"] == jpayload["schedule_ir"]
    assert payload["watermark"]["per_slot"]
    rc, out = _run(main, ["mlp", "Zero1", "--mesh", "data=8", "--dump-ir",
                          "dot"])
    assert rc == 0 and out.startswith("digraph")


def test_search_report_cli():
    """The JAX package's ``test_search.py:178``: top-K candidates with the
    per-leg-kind breakdown; the JSON's best candidate equals the JAX
    CLI's."""
    rc, out = _run(main, ["mlp", "--search-report", "--mesh", "data=4",
                          "--topk", "3"])
    assert rc == 0
    assert "top candidates" in out and "per-leg-kind" in out
    rc, out = _run(main, ["mlp", "--search-report", "--mesh", "data=4",
                          "--json"])
    _, jout = _run(jmain, ["mlp", "--search-report", "--mesh", "data=4",
                           "--json"])
    report, jreport = json.loads(out), json.loads(jout)
    assert rc == 0 and report["best"]["per_kind_ms"]
    assert report["n_evals"] == jreport["n_evals"] > 0
    assert report["best"]["fingerprint"] == jreport["best"]["fingerprint"]


def test_cli_lists_usage_and_elastic():
    rc, out = _run(main, ["--list-models"])
    assert rc == 0 and out == _run(jmain, ["--list-models"])[1]
    rc, out = _run(main, ["--list-rules"])
    assert rc == 0 and "== pass: legality ==" in out
    with pytest.raises(SystemExit) as err:
        main(["mlp"])
    assert err.value.code == 2
    rc, out = _run(main, ["mlp", "Zero1", "--mesh", "data=4",
                          "--elastic-from", "data=8"])
    assert rc == 0 and "elastic/axis-resize" in out \
        and "elastic/hbm-grows" in out
