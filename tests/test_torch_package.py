"""Boundaries of the port package: no JAX, nothing of the JAX package, no
silent CPU fallback, and a chip smoke test that refuses to run alone."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from autodist_tpu_torch.models import base
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.serving import PagedDecodeEngine, serve

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
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('autodist_tpu', 'jax', 'flax', 'optax') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


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


def test_build_paths_stay_in_the_checkout():
    from autodist_tpu_torch.ops import _build

    assert _build.BUILD_DIR == ROOT / "build" / "kernels"
    assert {p.name for p in (PACKAGE / "csrc").glob("*.cu")} \
        == set(_build.SOURCES)
    path = _build.library_path("paged_attention.cu")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
