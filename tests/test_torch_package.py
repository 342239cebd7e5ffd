"""Boundaries of the port package: no JAX, nothing of the JAX package, no
silent CPU fallback, and a chip smoke test that refuses to run alone."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.models import base
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.serving import PagedDecodeEngine, serve
from autodist_tpu_torch.strategy import AllReduce

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
        "import autodist_tpu_torch.strategy.zero1_strategy\n"
        "import autodist_tpu_torch.kernel.synchronization.explicit_sync\n"
        "import autodist_tpu_torch.profile_train\n"
        "import autodist_tpu_torch.profile_flash, autodist_tpu_torch.fit\n"
        "import autodist_tpu_torch.profile_serving\n"
        "import autodist_tpu_torch.device_timer\n"
        "import autodist_tpu_torch.strategy.auto_strategy\n"
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


@pytest.mark.parametrize("name,item", [
    ("AutoStrategy", "P8 — cost model, search and AutoStrategy")])
def test_unported_strategy_builders_import_and_raise_naming_their_item(
        name, item):
    """Every builder the JAX package exports imports from the port; an
    unported one raises when built, naming its ROADMAP item."""
    import autodist_tpu.strategy as jstrategy
    import autodist_tpu_torch.strategy as strategy
    from autodist_tpu_torch.strategy import StrategyBuilder

    builders = {n for n in jstrategy.__all__
                if isinstance(getattr(jstrategy, n), type)
                and issubclass(getattr(jstrategy, n),
                               jstrategy.StrategyBuilder)}
    assert name in builders and builders <= set(strategy.__all__)
    builder = getattr(strategy, name)
    assert issubclass(builder, StrategyBuilder)
    with pytest.raises(NotImplementedError, match=f"ROADMAP: {item}"):
        builder()


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


def test_build_paths_stay_in_the_checkout():
    from autodist_tpu_torch.ops import _build

    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert {p.name for p in (PACKAGE / "csrc").glob("*.cu")} \
        == set(_build.SOURCES)
    assert {"flash_attention.cu", "fused_sync.cu"} <= set(_build.SOURCES)
    path = _build.library_path("paged_attention.cu")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
