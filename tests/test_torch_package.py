"""Boundaries of the port package: no JAX, nothing of the JAX package, no
silent CPU fallback, and a chip smoke test that refuses to run alone.
The public surface (F3): every public name of the JAX package at the top
level, in ``ops``, ``models`` and ``autodist``, and on ``AutoDist`` and
``DistributedSession`` exists in the port, or raises ``not_ported`` naming
its ROADMAP item, or is one of :data:`JAX_ONLY_MODULES`; the session's
``run_epoch``, ``set_params``, ``load_state``, ``restore_targets``,
``sharded_params``, ``flops_per_step`` and ``mfu``."""
import importlib
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import models, optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.const import P10, P11, P12
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models import base
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.fused_kernels import fusable_adam
from autodist_tpu_torch.serving import DecodeEngine, PagedDecodeEngine, serve
from autodist_tpu_torch.strategy import AllReduce, Zero1

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "autodist_tpu_torch"


def test_imports_with_jax_blocked_and_loads_nothing_of_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import autodist_tpu_torch, autodist_tpu_torch.convert\n"
        "import autodist_tpu_torch.models, autodist_tpu_torch.ops\n"
        "import autodist_tpu_torch.serving, autodist_tpu_torch.ops._build\n"
        "import autodist_tpu_torch.autodist, autodist_tpu_torch.optim\n"
        "import autodist_tpu_torch.const, autodist_tpu_torch.mesh\n"
        "import autodist_tpu_torch.resource_spec, autodist_tpu_torch.runner\n"
        "import autodist_tpu_torch.graph_item, autodist_tpu_torch.strategy\n"
        "import autodist_tpu_torch.strategy.compiler\n"
        "import autodist_tpu_torch.kernel.graph_transformer\n"
        "import autodist_tpu_torch.kernel.synchronization.bucketing\n"
        "import autodist_tpu_torch.ops.flash_attention\n"
        "import autodist_tpu_torch.ops.fused_kernels\n"
        "import autodist_tpu_torch.numerics, autodist_tpu_torch.numerics.guard\n"
        "import autodist_tpu_torch.numerics.loss_scale\n"
        "import autodist_tpu_torch.numerics.policy\n"
        "import autodist_tpu_torch.checkpoint.saver\n"
        "import autodist_tpu_torch.checkpoint.saved_model_builder\n"
        "import autodist_tpu_torch.ops.opt_state_dtype\n"
        "import autodist_tpu_torch.strategy.zero1_strategy\n"
        "import autodist_tpu_torch.kernel.synchronization.explicit_sync\n"
        "import autodist_tpu_torch.profile_train\n"
        "import autodist_tpu_torch.profile_flash, autodist_tpu_torch.fit\n"
        "import autodist_tpu_torch.profile_serving\n"
        "import autodist_tpu_torch.device_timer\n"
        "import autodist_tpu_torch.strategy.auto_strategy\n"
        "import autodist_tpu_torch.strategy.cost_model\n"
        "import autodist_tpu_torch.strategy.search\n"
        "import autodist_tpu_torch.analysis\n"
        "import autodist_tpu_torch.analysis.analyzer\n"
        "autodist_tpu_torch.analysis.analyzer._load_passes()\n"
        "import autodist_tpu_torch.analysis.search\n"
        "import autodist_tpu_torch.analysis.simulate\n"
        "import autodist_tpu_torch.analysis.__main__\n"
        "import autodist_tpu_torch.checkpoint.tiers\n"
        "import autodist_tpu_torch.strategy.tuner\n"
        "import autodist_tpu_torch.patch, autodist_tpu_torch.ops.leg_cursor\n"
        "import autodist_tpu_torch.kernel.synchronization.schedule_ir\n"
        "import autodist_tpu_torch.telemetry\n"
        "import autodist_tpu_torch.telemetry.__main__\n"
        "import autodist_tpu_torch.utils.tracing\n"
        "import autodist_tpu_torch.utils.logging\n"
        "import autodist_tpu_torch.utils.metrics\n"
        "import autodist_tpu_torch.resilience.backoff\n"
        "import autodist_tpu_torch.resilience.heartbeat\n"
        "import autodist_tpu_torch.resilience.chaos\n"
        "import autodist_tpu_torch.resilience.supervisor\n"
        "import autodist_tpu_torch.resilience.elastic\n"
        "import autodist_tpu_torch.serving.router\n"
        "from autodist_tpu_torch.resilience import Supervisor\n"
        "from autodist_tpu_torch import (AutoDist, ResourceSpec, DeviceSpec,\n"
        "    ENV, Callback, TimeHistory, History, __version__)\n"
        "from autodist_tpu_torch.strategy import (AutoStrategy,\n"
        "    PartitionedAR, RandomAxisPartitionAR)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('autodist_tpu', 'jax', 'flax', 'optax') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_top_level_exports_match_the_jax_package():
    """The JAX package's top-level names, each resolving (``AutoDist``
    and ``fit``'s callbacks lazily)."""
    import autodist_tpu
    import autodist_tpu_torch as port
    from autodist_tpu_torch.autodist import AutoDist as facade
    from autodist_tpu_torch.const import ENV
    from autodist_tpu_torch.resource_spec import DeviceSpec, ResourceSpec

    assert port.__all__ == autodist_tpu.__all__
    assert port.__version__ == autodist_tpu.__version__
    assert (port.AutoDist, port.ResourceSpec, port.DeviceSpec, port.ENV) \
        == (facade, ResourceSpec, DeviceSpec, ENV)
    spec = port.ResourceSpec(resource_info={"nodes": [
        {"address": "localhost", "gpus": [0, 1], "chief": True}]})
    assert all(isinstance(d, port.DeviceSpec) for d in spec.devices)
    assert len(spec.devices) == 2
    from autodist_tpu_torch import fit
    assert (port.Callback, port.TimeHistory, port.History) \
        == (fit.Callback, fit.TimeHistory, fit.History)
    assert port.History().history == {"loss": [], "loss_step": [],
                                      "epoch_loss": []}
    assert port.TimeHistory(8).items_per_step == 8
    assert issubclass(port.TimeHistory, port.Callback)
    with pytest.raises(AttributeError):
        port.NoSuchName  # noqa: B018


@pytest.mark.parametrize("chips", [1, 8])
@pytest.mark.parametrize("search", [False, True, "beam"])
def test_auto_strategy_builds_the_jax_package_plan(search, chips):
    """Every builder the JAX package exports is the port's, AutoStrategy
    too: in each search mode it builds the JAX package's plan on the
    small LM (``tests/test_torch_search.py`` holds the rest)."""
    import autodist_tpu.strategy as jstrategy
    from autodist_tpu.graph_item import GraphItem as JGraphItem
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec

    import autodist_tpu_torch.strategy as strategy
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.resource_spec import ResourceSpec

    builders = {n for n in jstrategy.__all__
                if isinstance(getattr(jstrategy, n), type)
                and issubclass(getattr(jstrategy, n),
                               jstrategy.StrategyBuilder)}
    assert "AutoStrategy" in builders and builders <= set(strategy.__all__)
    jspec = jax_lm(**LM)
    jparams = jspec.init(jax.random.PRNGKey(0))
    info = {"nodes": [{"address": "localhost", "chips": chips}]}
    jb = jstrategy.AutoStrategy(search=search)
    pb = strategy.AutoStrategy(search=search)
    want = jb.build(JGraphItem(jparams, optimizer=optax.adam(1e-3),
                               sparse_vars=jspec.sparse_vars),
                    JResourceSpec(resource_info=info))
    got = pb.build(GraphItem(params_from_jax(jparams),
                             optimizer=optim.adam(1e-3),
                             sparse_vars=jspec.sparse_vars),
                   ResourceSpec(resource_info=info))
    assert got.to_dict()["node_config"] == want.to_dict()["node_config"]
    assert pb.last_choice == jb.last_choice


def test_no_file_names_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + sorted(PACKAGE.rglob("*.cu")) \
        + [ROOT / "chip_smoke.py"]
    pattern = re.compile(r"\b(jax|flax|optax)\b|autodist_tpu\.")
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, "\n".join(hits)


def test_entry_points_raise_without_device_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = transformer_lm(vocab_size=11, num_layers=1, num_heads=1,
                          head_dim=4, d_ff=8, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_generator(spec)
    params = spec.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedDecodeEngine(spec, params, window=8, block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(spec, params, paged=True, port=0, window=8, block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(spec, params, window=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(spec, params, port=0, window=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        models.make_speculative_generator(spec, spec)(params, params,
                                                      [[1]], 2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        base.resolve_device("cuda")
    assert base.resolve_device("cpu") == torch.device("cpu")


def test_training_facade_raises_without_device_when_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoDist(strategy_builder=AllReduce())
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoDist(strategy_builder=AllReduce()).create_distributed_session()
    with pytest.raises(RuntimeError, match="CUDA"):
        AutoDist(strategy_builder=AllReduce(), device="cuda")
    spec = transformer_lm(vocab_size=11, num_layers=1, num_heads=1,
                          head_dim=8, d_ff=8, max_len=8)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=optim.adamw(1e-3), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    assert np.isfinite(float(sess.run(spec.sample_batch(2))["loss"]))
    assert sess.device_params["embed"].device == torch.device("cpu")


def test_engine_refuses_params_on_another_device():
    spec = transformer_lm(vocab_size=11, num_layers=1, num_heads=1,
                          head_dim=4, d_ff=8, max_len=16)
    params = spec.init(0, device="cpu")
    params["pos_embed"] = params["pos_embed"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        PagedDecodeEngine(spec, params, window=8, block_size=4,
                          device="cpu")


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout == ""


def test_profile_flash_variants_apply_and_it_needs_a_card(monkeypatch):
    """Each K2 design variant's substitution finds its text in the flash
    source and changes it; without a card the script exits 2."""
    from autodist_tpu_torch import profile_flash
    from autodist_tpu_torch.ops import _build

    text = (_build.CSRC / profile_flash.SOURCE).read_text()
    for name, subs in profile_flash.VARIANTS.items():
        assert profile_flash._variant_source(text, subs) != text, name
    with pytest.raises(ValueError, match="not found"):
        profile_flash._variant_source(text, [("no such text", "")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_flash.main() == 2


def test_profile_serving_probes_apply_and_it_needs_a_card(monkeypatch):
    """Each K10 probe's substitution finds its text in the int8 source
    and changes it; without a card the script exits 2."""
    from autodist_tpu_torch import profile_flash, profile_serving
    from autodist_tpu_torch.ops import _build

    text = (_build.CSRC / profile_serving.SOURCE).read_text()
    for name, subs in profile_serving.PROBES.items():
        assert profile_flash._variant_source(text, subs) != text, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profile_serving.main() == 2


def test_ptxas_report_is_parsed_per_flash_kernel():
    from autodist_tpu_torch.ops import _build

    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_115flash_dq_kernelILi64ELb1EEEvPKfS2_'\n"
           "ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 182 registers, used 0 barriers, 384 bytes "
           "cmem[0]\n"
           "ptxas info    : Compiling entry function 'other_kernel'\n"
           "ptxas info    : Used 40 registers, 32768 bytes smem\n")
    assert _build.parse_ptxas(log) == {
        "flash_dq_kernel<64, causal>": {"stack": 0, "spill_stores": 0,
                                        "spill_loads": 0, "registers": 182,
                                        "static_smem": 0},
        "other_kernel": {"registers": 40, "static_smem": 32768}}


def test_concurrent_builds_of_a_library_serialize_on_its_file_lock(
        tmp_path):
    """Two processes that find a kernel library missing at once build it
    once: the second waits on the library's file lock and finds it built.
    A stub ``nvcc`` (``CUDA_HOME``) logs each run and takes a second."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    stub = home / "bin" / "nvcc"
    stub.write_text(
        "#!" + sys.executable + "\n"
        "import os, sys, time\n"
        f"log = open({str(log)!r}, 'a')\n"
        "log.write(f'start {os.getpid()} {time.time()}\\n'); log.flush()\n"
        "time.sleep(1.0)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n"
        "log.write(f'end {os.getpid()} {time.time()}\\n')\n")
    stub.chmod(0o755)
    code = ("import sys; from pathlib import Path\n"
            "from autodist_tpu_torch.ops import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "_build.SOURCES = ('leg_cursor.cu',)\n"
            "print(_build.build_all()['leg_cursor.cu'].read_text())\n")
    env = dict(os.environ, CUDA_HOME=str(home))
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "kernels")], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert [o.strip() for o in outs] == ["lib", "lib"]
    runs = log.read_text().split()
    assert runs[0::3] == ["start", "end"]       # one build, not two
    libs = list((tmp_path / "kernels").glob("leg_cursor-*.so"))
    assert len(libs) == 1
    assert (libs[0].parent / (libs[0].name + ".lock")).exists()


def test_build_paths_stay_in_the_checkout():
    from autodist_tpu_torch.ops import _build

    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert {p.name for p in (PACKAGE / "csrc").glob("*.cu")} \
        == set(_build.SOURCES)
    assert {"flash_attention.cu", "fused_sync.cu"} <= set(_build.SOURCES)
    path = _build.library_path("paged_attention.cu")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# --- the public surface (F3) ------------------------------------------------

#: JAX modules the port has no counterpart of, with the reason
JAX_ONLY_MODULES = {
    "autodist_tpu.ops.pallas_utils": "Pallas helpers: the port has no Pallas",
    "autodist_tpu.parallel": P10,
    "autodist_tpu.utils.compat": "JAX version shims: the port has no JAX",
    "autodist_tpu.utils.network": P12,
    "autodist_tpu.utils.visualization": "sharding renderings of JAX arrays",
}
LM = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
          max_len=16)


def _public(module):
    """A module's public names: its ``__all__``, else the names it binds to
    data or to objects of its own (a package: of its submodules), the
    submodules themselves left out."""
    if hasattr(module, "__all__"):
        return set(module.__all__)
    package = hasattr(module, "__path__")

    def own(v):
        where = getattr(v, "__module__", None)
        if where is None:
            return not inspect.ismodule(v)
        return where.startswith(module.__name__ + ".") if package \
            else where == module.__name__
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and own(v)}


@pytest.mark.parametrize("scope", ["", ".ops", ".models", ".autodist",
                                   ".ops.opt_state_dtype",
                                   ".checkpoint.saved_model_builder",
                                   ".telemetry", ".strategy", ".analysis",
                                   ".strategy.cost_model",
                                   ".strategy.search",
                                   ".kernel.synchronization.schedule_ir",
                                   ".checkpoint", ".checkpoint.tiers",
                                   ".strategy.tuner", ".patch",
                                   ".analysis.simulate", ".resilience",
                                   ".resilience.backoff",
                                   ".resilience.heartbeat",
                                   ".resilience.chaos",
                                   ".resilience.supervisor",
                                   ".resilience.elastic", ".serving",
                                   ".serving.router", ".serving.server"])
def test_public_names_of_each_scope_exist_in_the_port(scope):
    jmod = importlib.import_module("autodist_tpu" + scope)
    port = importlib.import_module("autodist_tpu_torch" + scope)
    names = _public(jmod)
    assert names, scope
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


@pytest.mark.parametrize("cls", ["AutoDist", "DistributedSession"])
def test_public_attributes_of_the_facade_and_session_exist_in_the_port(cls):
    module = "autodist" if cls == "AutoDist" else "runner"
    jcls = getattr(importlib.import_module(f"autodist_tpu.{module}"), cls)
    pcls = getattr(importlib.import_module(f"autodist_tpu_torch.{module}"),
                   cls)
    missing = sorted(n for n in dir(jcls)
                     if not n.startswith("_") and not hasattr(pcls, n))
    assert not missing, missing


@pytest.mark.parametrize("name", sorted(JAX_ONLY_MODULES))
def test_jax_only_modules_are_jax_modules_the_port_lacks(name):
    assert importlib.util.find_spec(name) is not None
    port = name.replace("autodist_tpu", "autodist_tpu_torch", 1)
    parent, _, child = port.rpartition(".")
    assert importlib.util.find_spec(port) is None
    assert not hasattr(importlib.import_module(parent), child)


@pytest.fixture
def lm_session(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**LM)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=optim.adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars)
    return spec, ad, ad.create_distributed_session()


def _with_env(name, value, fn):
    """``fn()`` with environment variable ``name`` set to ``value``."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def _drain_server(spec, params):
    """``serve(drain_on_sigterm=True)``: it installs the SIGTERM drain on
    this (the main) thread; the server is closed and the previous handler
    put back."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    srv = serve(spec, params, paged=True, device="cpu", port=0, window=16,
                block_size=8, drain_on_sigterm=True)
    try:
        assert signal.getsignal(signal.SIGTERM) is not before
        assert srv.stats()["draining"] is False
    finally:
        srv.close()
        signal.signal(signal.SIGTERM, before)


def _stub_calls(spec, ad, sess):
    from autodist_tpu_torch.runner import DistributedSession
    from autodist_tpu_torch.strategy import ScheduleTuner
    from autodist_tpu_torch.telemetry import LegProfiler, flightrec

    params = sess.device_params
    return {
        "models.moe_transformer_lm": (models.moe_transformer_lm, P10),
        "models.pipelined_transformer_lm": (models.pipelined_transformer_lm,
                                            P10),
        "models.pipelined_moe_transformer_lm": (
            models.pipelined_moe_transformer_lm, P10),
        "AutoDist.cluster": (lambda: ad.cluster, P12),
        "AutoDist.coordinator": (lambda: ad.coordinator, P12),
        # P8's second half, ported since: each now runs (item None)
        "LegProfiler.profile_ir": (lambda: LegProfiler().profile_ir(
            sess.schedule_ir), None),
        "flightrec.traced_stamp": (lambda: flightrec.traced_stamp("leg"),
                                   None),
        "fit(tuner=)": (lambda: sess.fit(
            spec.sample_batch(2), epochs=1, steps_per_epoch=1,
            tuner=ScheduleTuner(ad.graph_item, ad.resource_spec,
                                calibration_path=None)), None),
        "AUTODIST_FLIGHTREC=legs": (lambda: _with_env(
            "AUTODIST_FLIGHTREC", "legs",
            lambda: DistributedSession(sess._gi, sess._step)), None),
        "session.place_local_batch": (
            lambda: sess.place_local_batch(spec.sample_batch(2)), P12),
        # the SIGTERM drain, ported with the router (item None: it runs)
        "serve(drain_on_sigterm=True)": (lambda: _drain_server(
            spec, params), None),
        "PagedDecodeEngine(mesh=)": (lambda: PagedDecodeEngine(
            spec, params, device="cpu", mesh=object()), P10),
    }


STUBS = ["models.moe_transformer_lm", "models.pipelined_transformer_lm",
         "models.pipelined_moe_transformer_lm", "AutoDist.cluster",
         "AutoDist.coordinator", "LegProfiler.profile_ir",
         "flightrec.traced_stamp", "fit(tuner=)",
         "AUTODIST_FLIGHTREC=legs", "session.place_local_batch",
         "serve(drain_on_sigterm=True)", "PagedDecodeEngine(mesh=)"]


def _ported_calls(spec, params):
    """The P11 names that raised until the serving slice: each call and
    a check of what it returns.  Servers are closed by the caller."""
    from autodist_tpu_torch.runtime import BPETokenizer

    small = dict(device="cpu", port=0, window=16)
    paged = dict(small, paged=True, block_size=8)
    gen = torch.Generator().manual_seed(0)
    prompt = np.array([[1, 2, 3]], np.int32)
    return {
        "models.lora_init": (
            lambda: models.lora_init(gen, params),
            lambda ad: ad and all(set(v) == {"a", "b"} for v in ad.values())),
        "models.lora_merge": (
            lambda: models.lora_merge(params, {}, alpha=2.0, rank=1),
            lambda tree: flatten(tree) == flatten(params)),
        "models.lora_setup": (
            lambda: models.lora_setup(params, spec.loss_fn, rng=gen),
            lambda setup: setup.capture_args["untrainable_vars"]
            == ("base",)),
        "models.make_speculative_generator": (
            lambda: models.make_speculative_generator(
                spec, spec, device="cpu")(params, params, prompt, 4, 2),
            lambda out: torch.equal(out[0], make_generator(
                spec, device="cpu")(params, prompt, 4))),
        "serve(paged=False)": (
            lambda: serve(spec, params, **small),
            lambda srv: type(srv.engine) is DecodeEngine),
        "serve(tokenizer=)": (
            lambda: serve(spec, params, tokenizer=BPETokenizer([]),
                          **paged),
            lambda srv: srv._tokenizer is not None),
        "serve(prefix_text=)": (
            lambda: serve(spec, params, tokenizer=BPETokenizer([]),
                          prefix_text="\x01\x02", **paged),
            lambda srv: srv.engine.prefix_len == 2),
        "serve(speculative=)": (
            lambda: serve(spec, params, **paged,
                          speculative={"spec": spec, "params": params}),
            lambda srv: srv.engine._draft_spec is spec),
        "PagedDecodeEngine(draft_spec=)": (
            lambda: PagedDecodeEngine(spec, params, device="cpu", window=16,
                                      block_size=8, draft_spec=spec,
                                      draft_params=params),
            lambda eng: eng.scheduler_stats()["speculative"]["gamma"] == 4),
    }


PORTED = ["models.lora_init", "models.lora_merge", "models.lora_setup",
          "models.make_speculative_generator", "serve(paged=False)",
          "serve(tokenizer=)", "serve(prefix_text=)", "serve(speculative=)",
          "PagedDecodeEngine(draft_spec=)"]


@pytest.mark.parametrize("name", STUBS)
def test_stubs_and_serving_refusals_name_their_roadmap_item(name,
                                                            lm_session):
    """Each stub raises naming its ROADMAP item; an entry whose item is
    None was ported since (P8's second half) and runs."""
    call, item = _stub_calls(*lm_session)[name]
    if item is None:
        call()
        return
    with pytest.raises(NotImplementedError) as err:
        call()
    assert str(err.value).endswith(f"(ROADMAP: {item})"), str(err.value)


def test_every_stub_is_checked():
    from types import SimpleNamespace

    assert sorted(STUBS) == sorted(_stub_calls(
        None, None, SimpleNamespace(device_params=None)))


@pytest.mark.parametrize("name", PORTED)
def test_ported_serving_slice_entry_points_run(name, lm_session):
    """The nine P11 refusals of the stub table now run (ROADMAP P11, the
    serving slice): ``serve()``'s default builds the slot engine."""
    spec, _, sess = lm_session
    assert sorted(PORTED) == sorted(_ported_calls(spec,
                                                  sess.device_params))
    call, check = _ported_calls(spec, sess.device_params)[name]
    out = call()
    try:
        assert check(out), name
    finally:
        if hasattr(out, "close"):
            out.close()


@pytest.mark.parametrize("name", ["session.telemetry",
                                  "session.telemetry (AUTODIST_TELEMETRY=0)"])
def test_ported_telemetry_entry_points_run(name, lm_session):
    """``session.telemetry`` raised (P9) until the telemetry slice: it is
    the session's step recorder, None with telemetry off."""
    from autodist_tpu_torch.runner import DistributedSession
    from autodist_tpu_torch.telemetry import StepRecorder

    spec, _, sess = lm_session
    if name == "session.telemetry":
        sess.run(spec.sample_batch(2))
        assert isinstance(sess.telemetry, StepRecorder)
        assert [r.step for r in sess.telemetry.records] == [0]
    else:
        off = _with_env("AUTODIST_TELEMETRY", "0",
                        lambda: DistributedSession(sess._gi, sess._step))
        assert off.telemetry is None


@pytest.mark.parametrize("name", ["session.schedule_ir",
                                  "session.schedule_fingerprint",
                                  "flightrec.publish_ir",
                                  "fit(validate=True)"])
def test_ported_schedule_ir_entry_points_run(name, lm_session, tmp_path):
    """The P8 refusals of the stub table now run (ROADMAP P8, first
    half): the session's IR is verified and equal to the JAX package's
    for the same facts, its fingerprint is the IR's, it publishes, and
    ``fit(validate=True)`` runs the analyzer before training."""
    from autodist_tpu.kernel.synchronization import schedule_ir as jsir

    from autodist_tpu_torch.kernel.synchronization import schedule_ir as sir
    from autodist_tpu_torch.telemetry import flightrec

    spec, _, sess = lm_session
    ir = sess.schedule_ir
    if name == "session.schedule_ir":
        assert not sir.errors(sir.verify(ir))
        facts = [jsir.PlanFact(name=v.name, shape=tuple(v.shape),
                               dtype=v.dtype, sync_kind="AllReduce")
                 for v in sess._gi.info.trainable_variables]
        assert ir.to_json() == jsir.ir_from_facts(
            facts, axes={"data": 1}).to_json()
    elif name == "session.schedule_fingerprint":
        assert sess.schedule_fingerprint == ir.fingerprint()
    elif name == "flightrec.publish_ir":
        path = flightrec.publish_ir(ir, str(tmp_path))
        assert path.endswith(f"schedule-{ir.fingerprint()}.json")
    else:
        hist = sess.fit(spec.sample_batch(2), epochs=1, steps_per_epoch=1,
                        validate=True)
        assert sess.step_count == 1 and len(hist.history["loss"]) == 1


def test_flash_attention_is_the_function_and_cross_entropy_exported():
    from autodist_tpu_torch.ops import flash_attention, make_flash_attention

    mod = importlib.import_module("autodist_tpu_torch.ops.flash_attention")
    assert flash_attention is mod.flash_attention
    assert make_flash_attention() is flash_attention
    assert models.cross_entropy_loss is base.cross_entropy_loss


def test_facade_exposes_its_graph_item_and_resource_spec(lm_session):
    from autodist_tpu_torch.autodist import get_default_autodist
    from autodist_tpu_torch.resource_spec import ResourceSpec

    _, ad, _ = lm_session
    assert get_default_autodist() is ad
    assert isinstance(ad.resource_spec, ResourceSpec)
    assert {v.name for v in ad.graph_item.info.variables} == {
        n for n, _ in flatten(ad.graph_item.params)}


def _jax_lm_session(params, builder):
    jax_reset()
    jspec = jax_lm(**LM, attn_fn=jax_dense)
    ad = JAutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=params, optimizer=optax.adam(1e-2),
                   loss_fn=jspec.loss_fn, sparse_vars=jspec.sparse_vars)
    return ad.create_distributed_session(
        mesh=jax_build_mesh(devices=jax.devices()[:1]))


def _port_lm_session(params, builder, optimizer=None):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**LM)
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=optimizer or optim.adam(1e-2),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    return ad.create_distributed_session()


def test_session_state_methods_follow_the_jax_session(monkeypatch):
    """On the tiny LM from the JAX init, both sessions: ``run_epoch`` over
    3 batches returns the last step's metrics (losses at rtol 1e-5);
    ``set_params`` puts the init back with a fresh optimizer, so the next
    step's loss is the first step's again; ``load_state`` of a session's
    own exported-then-placed state resumes it (the next loss equal to a
    session that ran on); ``sharded_params`` is the device tree;
    ``restore_targets`` has the logical shapes and dtypes of
    ``export_state`` (the parameters' the JAX session's too), on ``meta``
    tensors, the ZeRO-1 state vectors ``padded_total`` long."""
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    jspec = jax_lm(**LM, attn_fn=jax_dense)
    params = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    batches = [jspec.sample_batch(8, seed=s) for s in range(3)]
    jsess = _jax_lm_session(params, JAllReduce())
    sess = _port_lm_session(params, AllReduce())
    jlast = jsess.run_epoch(batches)
    last = sess.run_epoch(batches)
    assert sess.step_count == jsess.step_count == 3
    np.testing.assert_allclose(last["loss"], jlast["loss"], rtol=1e-5)
    assert sess.sharded_params is sess.device_params

    first = float(_port_lm_session(params, AllReduce()).run(
        batches[0])["loss"])
    sess.set_params(params_from_jax(params))
    jsess.set_params(params)
    jloss = float(jsess.run(batches[0])["loss"])
    assert float(sess.run(batches[0])["loss"]) == first
    np.testing.assert_allclose(first, jloss, rtol=1e-5)

    saved = sess.export_state()
    ahead = float(sess.run(batches[1])["loss"])
    sess.load_state(*saved, step=7, sync_state=sess.sync_state)
    assert sess.step_count == 7
    assert float(sess.run(batches[1])["loss"]) == ahead

    jparams = dict(flatten(jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), jsess.restore_targets()[0],
        is_leaf=lambda a: hasattr(a, "shape"))))
    for builder in (AllReduce(), Zero1(bucket_bytes=4096)):
        s = _port_lm_session(params, builder, fusable_adam(1e-2))
        s.run(batches[0])
        targets, exported = s.restore_targets(), s.export_state()
        for got, want in zip(targets, exported):
            got, want = dict(flatten(got)), dict(flatten(want))
            assert got.keys() == want.keys()
            for n, x in want.items():
                if isinstance(x, torch.Tensor):
                    assert got[n].device.type == "meta", n
                    assert (got[n].shape, got[n].dtype) == (x.shape, x.dtype)
        assert {n: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                for n, x in flatten(targets[0])} == jparams


@pytest.mark.parametrize("embedded,factor", [(True, 6), (False, 4)])
def test_flops_per_step_counts_one_dense_layer(embedded, factor,
                                               monkeypatch):
    """One dense layer ``[B, in] @ [in, out]``: the forward, the weight
    gradient and, when its input is a trainable table's rows (the gather
    counts 0), the input gradient, 2·B·in·out each; without an input that
    takes a gradient autograd runs no input product, so 4·B·in·out.  None
    before the first step, and ``mfu()`` None on the CPU."""
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()
    b, n_in, n_out = 16, 24, 10
    rng = np.random.RandomState(0)
    params = {"table": torch.from_numpy(rng.randn(32, n_in).astype(
        np.float32)), "w": torch.from_numpy(rng.randn(n_in, n_out).astype(
            np.float32))}

    def loss_fn(p, batch):
        x = p["table"][torch.as_tensor(batch["ids"]).long()] if embedded \
            else torch.as_tensor(batch["x"])
        return torch.log_softmax(x @ p["w"], dim=-1).mean()

    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params, optimizer=optim.sgd(1e-2),
                   loss_fn=loss_fn)
    sess = ad.create_distributed_session()
    assert sess.flops_per_step() is None and sess.mfu() is None
    batch = {"ids": rng.randint(0, 32, (b,)).astype(np.int32),
             "x": rng.randn(b, n_in).astype(np.float32)}
    for _ in range(3):
        sess.run(batch)
    assert sess.flops_per_step() == factor * b * n_in * n_out
    assert sess.mfu() is None
