"""Implicit program capture in the port (``autodist_tpu_torch/patch.py``)
against the JAX package's (``tests/test_patch.py``).

A plain script inside ``ad.scope()`` builds its optimizer through
``autodist_tpu_torch.optim``, calls ``opt.init(params)`` and takes
``torch.func.grad_and_value`` (or ``grad``) of ``loss_fn(params, batch)``;
the facade assembles the GraphItem from what it saw.  The implicitly
captured session trains as the explicit ``capture()`` one, bit for bit,
and as the JAX package's implicitly captured session (rtol 1e-6); the
namespaces come back on scope exit; ``has_aux`` is recorded, also
positionally; a tensor of a ``torch.func`` transform is not recorded as
the parameters; a second gradient warns; ``AUTODIST_PATCH=False`` turns
the capture off.  The port's ``optim`` has no ``chain``, so the JAX
package's ``test_chain_records_outermost_transformation`` has no twin.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.func

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jreset
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.patch import PatchOptim
from autodist_tpu_torch.strategy import AllReduce

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()
    jreset()
    yield
    if PatchOptim.active_record() is not None:
        PatchOptim.unpatch()
    _reset_default_autodist_for_testing()
    jreset()


def _params():
    return {"w": torch.arange(4.0), "b": torch.zeros(())}


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _batch(n=8):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    return {"x": x, "y": (x @ np.arange(4.0) + 1.0).astype(np.float32)}


def _ad():
    _reset_default_autodist_for_testing()
    return AutoDist(strategy_builder=AllReduce(), device="cpu")


def test_plain_script_is_captured_implicitly():
    ad = _ad()
    with ad.scope():
        opt = optim.sgd(0.1)
        opt.init(_params())
        torch.func.grad_and_value(_loss)
    sess = ad.create_distributed_session()
    m1 = sess.run(_batch())
    m2 = sess.run(_batch())
    assert m2["loss"] < m1["loss"]
    assert ad._implicit_record.optimizer_factory == "sgd"


def test_implicit_matches_explicit_and_the_jax_package():
    batch = _batch()
    ad1 = _ad()
    with ad1.scope():
        opt = optim.adamw(1e-2)
        opt.init(_params())
        torch.func.grad_and_value(_loss)
    s1 = ad1.create_distributed_session()

    ad2 = _ad()
    with ad2.scope():
        ad2.capture(params=_params(), optimizer=optim.adamw(1e-2),
                    loss_fn=_loss)
    s2 = ad2.create_distributed_session()

    def jloss(params, b):
        pred = b["x"] @ params["w"] + params["b"]
        return jnp.mean((pred - b["y"]) ** 2)

    jad = JAutoDist(strategy_builder=JAllReduce())
    with jad.scope():
        jopt = optax.adamw(1e-2)
        jopt.init({"w": jnp.arange(4.0), "b": jnp.zeros(())})
        jax.value_and_grad(jloss)
    s3 = jad.create_distributed_session()

    for _ in range(3):
        l1 = s1.run(batch)["loss"]
        l2 = s2.run(batch)["loss"]
        l3 = s3.run(batch)["loss"]
        assert l1 == l2
        np.testing.assert_allclose(l1, l3, rtol=1e-6)
    assert all(np.array_equal(s1.params[k], s2.params[k]) for k in ("w", "b"))


def test_has_aux_flag_is_captured():
    def loss_aux(params, batch):
        return _loss(params, batch), {"l2": torch.sum(params["w"] ** 2)}

    ad = _ad()
    with ad.scope():
        opt = optim.sgd(0.1)
        opt.init(_params())
        torch.func.grad_and_value(loss_aux, has_aux=True)
    metrics = ad.create_distributed_session().run(_batch())
    assert "aux" in metrics and "l2" in metrics["aux"]


def test_explicit_capture_wins_over_implicit():
    ad = _ad()
    with ad.scope():
        opt = optim.sgd(0.5)
        opt.init({"w": torch.ones(2), "b": torch.zeros(())})
        ad.capture(params=_params(), optimizer=optim.sgd(0.1),
                   loss_fn=_loss)
    assert ad.create_distributed_session().params["w"].shape == (4,)


def test_scope_exit_restores_namespaces():
    orig_adam, orig_gv = optim.adam, torch.func.grad_and_value
    orig_grad = torch.func.grad
    ad = _ad()
    with ad.scope():
        assert optim.adam is not orig_adam
        assert torch.func.grad_and_value is not orig_gv
        assert torch.func.grad is not orig_grad
        assert optim.flatten is not None and optim.GradientTransformation \
            is not None          # classes and imports stay untouched
    assert optim.adam is orig_adam
    assert torch.func.grad_and_value is orig_gv
    assert torch.func.grad is orig_grad


def test_incomplete_capture_reports_whats_missing():
    ad = _ad()
    with ad.scope():
        optim.sgd(0.1).init(_params())
    with pytest.raises(RuntimeError, match="loss_fn"):
        ad.create_distributed_session()


def test_nothing_captured_keeps_legacy_error():
    ad = _ad()
    with ad.scope():
        pass
    with pytest.raises(RuntimeError, match="capture"):
        ad.create_distributed_session()


def test_transform_tensors_are_not_captured():
    """``opt.init`` under a ``torch.func`` transform sees the transform's
    tensors (the counterpart of a JAX tracer): not recorded."""
    ad = _ad()
    with ad.scope():
        opt = optim.sgd(0.1)

        def init_under_vmap(w):
            opt.init({"w": w, "b": torch.zeros(())})
            return w.sum()

        torch.func.vmap(init_under_vmap)(torch.ones(3, 4))
        assert ad._implicit_record is None
        assert PatchOptim.active_record().params is None
        opt.init(_params())
        torch.func.grad(_loss)
    rec = ad._implicit_record
    assert rec.params is not None and rec.params["w"].shape == (4,)
    assert not torch._C._functorch.is_functorch_wrapped_tensor(
        rec.params["w"])


def test_patch_gate_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_PATCH", "False")
    orig_adam = optim.adam
    ad = _ad()
    with ad.scope():
        assert optim.adam is orig_adam


def test_positional_has_aux_captured():
    def loss_aux(p, b):
        return torch.sum(p ** 2), {"n": torch.sum(b)}

    rec = PatchOptim.patch()
    try:
        torch.func.grad_and_value(loss_aux, 0, True)
    finally:
        out = PatchOptim.unpatch()
    assert out is rec
    assert rec.loss_fn is loss_aux
    assert rec.has_aux is True


def test_loss_fn_overwrite_warns(caplog):
    def train_loss(p, b):
        return torch.sum(p ** 2)

    def diag(p, b):
        return torch.sum(p)

    PatchOptim.patch()
    try:
        with caplog.at_level(logging.WARNING,
                             logger="autodist_tpu_torch.patch"):
            torch.func.grad_and_value(train_loss)
            torch.func.grad(diag)
    finally:
        rec = PatchOptim.unpatch()
    assert rec.loss_fn is diag
    assert any("replaces previously recorded" in r.getMessage()
               for r in caplog.records)
