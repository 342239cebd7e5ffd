"""The port's twins of the example scripts (``examples_torch/``) on the CPU.

Each twin runs in this process (``main(argv)``, ``--device cpu``) at the
arguments ``tests/test_examples.py`` gives its JAX script, and prints the
lines that test asserts; a twin whose JAX test is marked ``integration``
is marked so too (on the card ``chip_smoke.py`` runs every twin at full
length).  ``benchmark/bert.py`` and ``benchmark/ncf.py``, which the JAX
suite does not run, run at small sizes.  Against the JAX scripts, run
here too on the 8-device CPU mesh: ``linear_regression``'s printed losses
at rtol 1e-5, and the losses of every step of ``benchmark/ncf.py`` and
``lm1b/lm1b_train.py`` at rtol 1e-4, the twins handed the JAX scripts'
initial parameters through ``main(params=...)``.  Every twin imports
with ``jax`` and ``autodist_tpu`` blocked.
"""
import importlib
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.runner import DistributedSession as JSession
from autodist_tpu_torch.autodist import _reset_default_autodist_for_testing
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.runner import DistributedSession

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.torch_port

#: every twin, by module under ``examples_torch``
TWINS = ("linear_regression", "image_classifier", "generate_text",
         "sentiment_classifier", "lora_finetune", "serving_engine",
         "serve_http", "speculative_draft", "benchmark.common",
         "benchmark.imagenet", "benchmark.bert", "benchmark.ncf",
         "lm1b.lm1b_train", "long_context", "input_pipeline",
         "implicit_capture", "pipeline_1f1b", "moe_pipeline")


@pytest.fixture(autouse=True)
def _one_thread_and_testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset_default_autodist_for_testing()
    yield
    torch.set_num_threads(threads)


def _twin(name):
    return importlib.import_module(f"examples_torch.{name}")


def _run(capsys, name, args=()):
    """The twin's ``main`` on the CPU at ``args``: its return value and
    what it printed."""
    result = _twin(name).main([*args, "--device", "cpu"])
    return result, capsys.readouterr().out


def test_linear_regression(capsys):
    _, out = _run(capsys, "linear_regression")
    assert "w=" in out or "loss" in out.lower()


def test_image_classifier(capsys):
    _, out = _run(capsys, "image_classifier",
                  ("--image-size", "32", "--batch-size", "8", "--steps",
                   "3"))
    assert "step 2: loss" in out


@pytest.mark.integration
def test_imagenet_benchmark(capsys):
    _run(capsys, "benchmark.imagenet",
         ("--model", "resnet50", "--image-size", "32", "--batch-size", "8",
          "--steps", "2", "--warmup", "1"))


@pytest.mark.integration
def test_imagenet_benchmark_fit_epochs(capsys):
    _, out = _run(capsys, "benchmark.imagenet",
                  ("--model", "resnet50", "--image-size", "32",
                   "--batch-size", "8", "--steps", "2", "--epochs", "2"))
    assert "epoch 1:" in out


def test_bert_benchmark(capsys):
    rate, out = _run(capsys, "benchmark.bert",
                     ("--size", "tiny", "--batch-size", "8", "--steps", "2",
                      "--warmup", "1"))
    assert "bert: " in out and "samples/sec" in out and rate > 0


def test_ncf_benchmark(capsys):
    rate, out = _run(capsys, "benchmark.ncf",
                     ("--num-users", "1024", "--num-items", "512",
                      "--batch-size", "64", "--steps", "2", "--warmup", "1"))
    assert "ncf: " in out and "samples/sec" in out and rate > 0


@pytest.mark.integration
def test_lm1b_train_example(capsys):
    _, out = _run(capsys, "lm1b.lm1b_train",
                  ("--vocab-size", "512", "--emb-dim", "16",
                   "--hidden-dim", "32", "--batch-size", "8", "--steps",
                   "5", "--warmup", "1"))
    assert "words" in out


@pytest.mark.integration
def test_sentiment_classifier_example(capsys):
    _, out = _run(capsys, "sentiment_classifier", ("--steps", "300"))
    assert "final loss" in out


@pytest.mark.integration
def test_generate_text_example(capsys):
    _, out = _run(capsys, "generate_text", ("--steps", "200"))
    assert "continuation accuracy:" in out


def test_serving_engine_example(capsys):
    _, out = _run(capsys, "serving_engine")
    assert "oracle-exact" in out
    assert "slot_utilization=" in out


def test_lora_finetune_example(capsys):
    _, out = _run(capsys, "lora_finetune", ("--steps", "30"))
    assert "lora_finetune demo OK" in out
    assert "base drift: 0.0" in out


def test_serve_http_example(capsys):
    _, out = _run(capsys, "serve_http")
    assert "serve_http demo OK" in out
    assert "stream:" in out


@pytest.mark.integration
def test_speculative_draft_example(capsys):
    _, out = _run(capsys, "speculative_draft")
    assert "acceptance rate:" in out
    assert "token-exact" in out


def test_implicit_capture_example(capsys):
    losses, out = _run(capsys, "implicit_capture")
    assert "step  35" in out and len(losses) == 40


def test_input_pipeline_example(capsys, tmp_path):
    rate, out = _run(capsys, "input_pipeline",
                     ("--epochs", "2", "--rows", "512", "--batch-size", "32",
                      "--checkpoint-dir", str(tmp_path / "ck")))
    assert "final loss" in out and "native loader True" in out
    assert (tmp_path / "ck").is_dir() and rate > 0


#: the long-context twin on 2 gloo ranks of one seq group, small
LONG_CONTEXT_RANK = (
    "import sys; sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})\n"
    "import torch, torch_launch\n"
    "torch.set_num_threads(1)\n"
    "rank, init = int(sys.argv[1]), sys.argv[2]\n"
    "torch_launch.init_process_group(init, 2, rank)\n"
    "from examples_torch import long_context\n"
    "rate = long_context.main(['--data-shards', '1', '--seq-shards', '2',"
    " '--seq-len', '64', '--batch-size', '2', '--steps', '2',"
    " '--warmup', '1', '--device', 'cpu'])\n"
    "print('RATE', rate)\n")


def test_long_context_example_on_two_seq_ranks(tmp_path):
    """The twin's ring attention on a ``{"data": 1, "seq": 2}`` mesh of 2
    gloo ranks (the caller made the process group): both ranks train and
    report the same losses."""
    import torch_launch

    code = LONG_CONTEXT_RANK.format(root=str(ROOT),
                                    tests=str(ROOT / "tests"))
    logs = torch_launch.run(lambda rank, init: ["-c", code, rank, init],
                            world=2, tmp_dir=tmp_path, timeout=240)
    lines = [[ln for ln in log.splitlines()
              if ln.startswith("transformer_lm:")] for log in logs]
    assert all(len(x) == 1 for x in lines), logs
    losses = [ln[0].split("loss ")[1] for ln in lines]
    assert losses[0] == losses[1]
    assert all("RATE" in log for log in logs)


PIPE_RANK = (
    "import sys; sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})\n"
    "import torch, torch_launch\n"
    "torch.set_num_threads(1)\n"
    "rank, init = int(sys.argv[1]), sys.argv[2]\n"
    "torch_launch.init_process_group(init, 2, rank)\n"
    "from examples_torch import {twin}\n"
    "out = {twin}.main({argv!r} + ['--device', 'cpu'])\n"
    "print('RESULT', out)\n")


@pytest.mark.parametrize("twin,argv", [
    ("pipeline_1f1b", ["--pipe", "2", "--data-shards", "1",
                       "--virtual-stages", "2", "--num-layers", "4",
                       "--seq-len", "16", "--batch-size", "8",
                       "--steps", "3"]),
    ("moe_pipeline", ["--pipe", "2", "--expert-shards", "1",
                      "--data-shards", "1", "--seq-len", "16",
                      "--steps", "2", "--warmup", "1"]),
])
def test_pipeline_twins_on_two_pipe_ranks(tmp_path, twin, argv):
    """The pipeline twins on a ``{"pipe": 2}`` mesh of 2 gloo ranks (the
    caller made the process group), at the JAX tests' arguments: the
    1F1B twin's interleaved 1F1B and GPipe runs agree (its own assert)
    and both ranks print the same losses; the MoE twin trains on both
    ranks with the same loss line."""
    import torch_launch

    code = PIPE_RANK.format(root=str(ROOT), tests=str(ROOT / "tests"),
                            twin=twin, argv=argv)
    logs = torch_launch.run(lambda rank, init: ["-c", code, rank, init],
                            world=2, tmp_dir=tmp_path, timeout=240)
    key = "  1f1b:" if twin == "pipeline_1f1b" \
        else "pipelined_moe_transformer_lm:"
    lines = [[ln for ln in log.splitlines() if ln.startswith(key)]
             for log in logs]
    assert all(len(x) == 1 for x in lines), logs
    if twin == "pipeline_1f1b":
        assert lines[0] == lines[1]
        assert all("max relative drift" in log for log in logs)
    else:
        assert lines[0][0].split("loss ")[1] == lines[1][0].split("loss ")[1]
    assert all("RESULT" in log for log in logs)


# -- against the JAX scripts -------------------------------------------------
def _record(monkeypatch, cls):
    """Every loss ``cls.run`` returns, in order (a host read per step)."""
    losses = []
    run = cls.run

    def recording(self, batch, *args, **kwargs):
        out = run(self, batch, *args, **kwargs)
        losses.append(float(np.asarray(out["loss"])))
        return out
    monkeypatch.setattr(cls, "run", recording)
    return losses


def _jax_main(monkeypatch, module, args=()):
    """A JAX example's ``main`` in this process (its flags through
    ``sys.argv``)."""
    jax_reset()
    monkeypatch.setattr(sys, "argv", [module, *args])
    importlib.import_module(module).main()


def test_linear_regression_prints_the_jax_scripts_losses(capsys,
                                                         monkeypatch):
    _jax_main(monkeypatch, "examples.linear_regression")
    want = capsys.readouterr().out
    _, got = _run(capsys, "linear_regression")
    pattern = r"step +(\d+) loss ([0-9.]+)"
    want_steps, got_steps = re.findall(pattern, want), \
        re.findall(pattern, got)
    assert [s for s, _ in got_steps] == [s for s, _ in want_steps] == \
        ["0", "50", "100", "150"]
    np.testing.assert_allclose([float(x) for _, x in got_steps],
                               [float(x) for _, x in want_steps], rtol=1e-5)
    learned = r"learned w=([0-9.]+) .*b=([0-9.]+)"
    assert re.findall(learned, got) == re.findall(learned, want)


@pytest.mark.parametrize("script,model,args", [
    ("benchmark.ncf", lambda: importlib.import_module(
        "autodist_tpu.models.ncf").ncf(num_users=1024, num_items=512),
     ("--num-users", "1024", "--num-items", "512", "--batch-size", "64",
      "--steps", "3", "--warmup", "1")),
    ("lm1b.lm1b_train", lambda: importlib.import_module(
        "autodist_tpu.models.lm1b").lm1b(vocab_size=512, seq_len=20,
                                         emb_dim=16, hidden_dim=32),
     ("--vocab-size", "512", "--emb-dim", "16", "--hidden-dim", "32",
      "--batch-size", "8", "--steps", "3", "--warmup", "1")),
], ids=["ncf", "lm1b"])
def test_training_twin_takes_the_jax_scripts_steps(monkeypatch, capsys,
                                                   script, model, args):
    """Every step's loss (warmup and timed) of the JAX script and of the
    twin from the JAX script's initial parameters, at rtol 1e-4."""
    want = _record(monkeypatch, JSession)
    _jax_main(monkeypatch, f"examples.{script}", args)
    got = _record(monkeypatch, DistributedSession)
    params = params_from_jax(jax.tree.map(
        np.asarray, model().init(jax.random.PRNGKey(0))))
    _twin(script).main([*args, "--device", "cpu"], params=params)
    capsys.readouterr()
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_twins_import_with_jax_and_the_jax_package_blocked():
    code = (
        "import importlib, sys\n"
        "for m in ('jax', 'flax', 'optax', 'autodist_tpu', 'examples'):\n"
        "    sys.modules[m] = None\n"
        f"for name in {TWINS!r}:\n"
        "    importlib.import_module('examples_torch.' + name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('autodist_tpu', 'jax', 'flax', 'optax', 'examples') "
        "and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
