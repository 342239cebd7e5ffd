"""The model export in the port against the JAX package:
``checkpoint.SavedModelBuilder`` / ``load_saved_model``
(``tests/test_checkpoint.py::test_saved_model_roundtrip``'s twin) and the
operators it exports K1 and K10 as.

Three programs are exported on the CPU: the JAX test's linear
``apply_fn`` on trained parameters, ``transformer_lm`` at depth 2 (its
plain attention, and the flash operator's plain version), and its int8
tree.  One fresh process that imports the checkpoint package and the
kernels' operators, and not ``autodist_tpu_torch.models``, serves them
all; each output is held against the eager forward at the JAX test's
rtol 1e-4 / atol 1e-5, and against the JAX package's own export of the
same function and weights (served by its ``load_saved_model``) at the
same tolerance.

``variables/`` is a directory of plain ``.npy`` files and an
``index.json``: numpy reads it back to the exported values.  The JAX
``Saver.restore_params`` reads Orbax's format only, so the cross-package
check goes through the values: the arrays numpy reads are what the JAX
export is made from.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from autodist_tpu.checkpoint.saved_model_builder import \
    SavedModelBuilder as JSavedModelBuilder
from autodist_tpu.checkpoint.saved_model_builder import \
    load_saved_model as jax_load_saved_model
from autodist_tpu.models import quantize as jquantize
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import SavedModelBuilder
from autodist_tpu_torch.convert import params_from_jax, params_to_numpy
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops import quant
from autodist_tpu_torch.ops.flash_attention import flash_attention
from autodist_tpu_torch.strategy import AllReduce

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=16)
CASES = ("linear", "lm", "lm_flash", "int8")
#: the serving process: loads each export on the CPU and writes its output
SERVE = """
import sys
import numpy as np
import autodist_tpu_torch.checkpoint
import autodist_tpu_torch.ops
from autodist_tpu_torch.checkpoint import load_saved_model
root = sys.argv[1]
out = {}
for case in sys.argv[2:]:
    fn = load_saved_model(f"{root}/{case}", device="cpu")
    out[case] = fn(np.load(f"{root}/{case}.input.npy")).numpy()
out["models_loaded"] = np.array(
    [m for m in sys.modules if m.startswith("autodist_tpu_torch.models")]
    or [""])
np.savez(f"{root}/served.npz", **out)
"""


def _linear_problem():
    """``tests/test_checkpoint.py``'s ``_problem``: a linear model trained
    3 steps under ``AllReduce`` (the port's session)."""
    rng = np.random.RandomState(0)
    params = {"linear": {"w": rng.randn(8, 4).astype(np.float32) * 0.1,
                         "b": np.zeros(4, np.float32)}}
    x = rng.randn(16, 8).astype(np.float32)
    y = rng.randn(16, 4).astype(np.float32)
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params), optimizer=optim.sgd(0.1),
                   loss_fn=lambda p, b: ((b["x"] @ p["linear"]["w"]
                                          + p["linear"]["b"] - b["y"])
                                         ** 2).mean())
    sess = ad.create_distributed_session()
    for _ in range(3):
        sess.run({"x": x, "y": y})
    return params_from_jax(sess.params), x


def _cases():
    """``{case: (port apply_fn, port params, input, JAX apply_fn, JAX
    params)}``."""
    trained, x = _linear_problem()

    def apply_linear(p, x):
        return x @ p["linear"]["w"] + p["linear"]["b"]

    jspec = jax_lm(**CFG, attn_fn=jax_dense)
    jparams = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    jq = jquantize.quantize_lm_params(jparams)
    tokens = np.random.RandomState(1).randint(0, CFG["vocab_size"], (2, 16)) \
        .astype(np.int32)
    lm = transformer_lm(**CFG)
    return {
        "linear": (apply_linear, trained, x, apply_linear,
                   params_to_numpy(trained)),
        "lm": (lm.apply_fn, params_from_jax(jparams), tokens,
               jspec.apply_fn, jparams),
        "lm_flash": (transformer_lm(**CFG, attn_fn=flash_attention).apply_fn,
                     params_from_jax(jparams), tokens, jspec.apply_fn,
                     jparams),
        "int8": (lm.apply_fn, params_from_jax(jax.tree.map(np.asarray, jq)),
                 tokens, jspec.apply_fn,
                 jquantize.dequantize_lm_params(jq, jspec)),
    }


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Each case exported by the port and served by one fresh process;
    ``(cases, root, served outputs)``."""
    root = tmp_path_factory.mktemp("export")
    cases = _cases()
    for case, (fn, params, x, _, _) in cases.items():
        builder = SavedModelBuilder(str(root / case))
        builder.add_graph_and_variables(fn, params, [x])
        assert builder.save() == str(root / case)
        np.save(root / f"{case}.input.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SERVE, str(root), *CASES],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    return cases, root, np.load(root / "served.npz")


@pytest.mark.parametrize("case", CASES)
def test_saved_model_roundtrip(exported, case):
    """Served without the models package, on the CPU: the eager output
    at rtol 1e-4 / atol 1e-5."""
    cases, _, served = exported
    fn, params, x, _, _ = cases[case]
    with torch.no_grad():
        want = fn(params, torch.from_numpy(x)).numpy()
    assert list(served["models_loaded"]) == [""]
    assert served[case].shape == want.shape
    np.testing.assert_allclose(served[case], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_export_matches_the_jax_export(exported, case, tmp_path):
    """``variables/`` reads back with numpy to the exported values, and
    the JAX package's export of the same function on those values (its
    ``load_saved_model``; the int8 tree's through its dequantized
    weights) serves the port's output at rtol 1e-4 / atol 1e-5."""
    cases, root, served = exported
    _, params, x, jfn, jparams = cases[case]
    var = root / case / "variables" / "params"
    with open(var / "index.json", encoding="utf-8") as f:
        assert "tree" in json.load(f)
    meta = json.loads((root / case / "saved_model_meta.json").read_text())
    assert meta["num_inputs"] == 1 and meta["input_shapes"] == [list(x.shape)]
    for name, leaf in flatten(params):
        pairs = ((f"{name}/q", leaf.q), (f"{name}/scale", leaf.scale)) \
            if isinstance(leaf, quant.Quantized) else ((name, leaf),)
        for n, t in pairs:
            np.testing.assert_array_equal(
                np.load(var / (n + ".npy")), t.detach().numpy(), err_msg=n)
    assert meta["quantized"] == [n for n, v in flatten(params)
                                 if isinstance(v, quant.Quantized)]
    builder = JSavedModelBuilder(str(tmp_path / "jax"))
    builder.add_graph_and_variables(jfn, jparams, [x])
    got = np.asarray(jax_load_saved_model(builder.save())(x))
    np.testing.assert_allclose(served[case], got, rtol=1e-4, atol=1e-5)


def test_exported_programs_hold_the_kernel_operators(exported):
    """The flash path exports one K1 operator per layer and the int8 tree
    one K10 operator per projection and the head; the plain-attention
    program has neither."""
    _, root, _ = exported

    def count(case):
        program = torch.export.load(str(root / case / "model.pt2"))
        return {str(n.target): 1 for n in program.graph.nodes
                if "autodist_tpu_torch" in str(n.target)}, sum(
            "autodist_tpu_torch" in str(n.target)
            for n in program.graph.nodes)

    layers = CFG["num_layers"]
    assert count("lm") == ({}, 0)
    assert count("lm_flash") == ({"autodist_tpu_torch.flash_fwd.default": 1},
                                 layers)
    assert count("int8") == ({"autodist_tpu_torch.int8_matmul.default": 1},
                             6 * layers + 1)


def test_fake_implementations_give_the_real_shapes():
    """K1's and K10's fake implementations (what ``torch.export`` traces
    with) give the CPU implementations' shapes and dtypes."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 3, 8).astype(np.float32))
               for _ in range(3))
    x = torch.from_numpy(rng.randn(2, 5, 16).astype(np.float32))
    w = quant.quantize_weight(torch.from_numpy(
        rng.randn(16, 24).astype(np.float32)))
    ops = torch.ops.autodist_tpu_torch
    real = [*ops.flash_fwd(q, k, v, True), ops.int8_matmul(x, w.q, w.scale)]
    with FakeTensorMode() as mode:
        fq, fk, fv, fx, fwq, fws = (mode.from_tensor(t)
                                    for t in (q, k, v, x, w.q, w.scale))
        fake = [*ops.flash_fwd(fq, fk, fv, True),
                ops.int8_matmul(fx, fwq, fws)]
    assert [(t.shape, t.dtype) for t in fake] \
        == [(t.shape, t.dtype) for t in real]
    assert [tuple(t.shape) for t in real] == [(2, 9, 3, 8), (2, 3, 9),
                                              (2, 5, 24)]


def test_loader_refuses_a_platform_the_export_lacks(tmp_path):
    builder = SavedModelBuilder(str(tmp_path / "e"), platforms=("cuda",))
    builder.add_graph_and_variables(lambda p, x: x @ p["w"],
                                    {"w": torch.ones(3, 2)},
                                    [np.ones((1, 3), np.float32)])
    from autodist_tpu_torch.checkpoint import load_saved_model

    with pytest.raises(ValueError, match="serves on"):
        load_saved_model(builder.save(), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        SavedModelBuilder(str(tmp_path / "f"), platforms=("cpu", "tpu"))

