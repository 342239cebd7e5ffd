"""Rematerialization in the port against the JAX package: ``capture(remat=)``
(``tests/test_remat.py``'s twin) and ``transformer_lm(remat=)``
(``tests/test_mfu_levers.py``'s), on one rank and on 2 gloo ranks.

Remat changes what the backward recomputes, not the math: the port's
losses under each policy equal its losses without remat at the JAX
tests' rtol/atol 1e-6 (they come out bit for bit), and its gradients at
rtol 1e-6 / atol 1e-7.  The port's run without remat is held against
the JAX 8-device session at rtol 1e-5, the port's float32 training
tolerance (``tests/test_torch_training.py``).
"""
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.flash_attention import \
    make_flash_attention as jax_flash
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import (_REMAT_POLICIES, GraphItem,
                                           flatten)
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops.flash_attention import flash_attention
from autodist_tpu_torch.strategy import AllReduce

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
CFG = worker.REMAT_CFG
#: ``tests/test_mfu_levers.py``'s model
LEVER_CFG = dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8,
                 d_ff=32, max_len=16, seq_len=16)
POLICIES = ["full", "dots", "dots_no_batch"]


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    jax_reset()
    _reset_default_autodist_for_testing()


@pytest.fixture(scope="module")
def problem():
    """``tests/test_remat.py``'s weights and batch, and the JAX 8-device
    session's 3 losses without remat."""
    jspec = jax_lm(**CFG)
    params = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    batch = jspec.sample_batch(8)
    jax_reset()
    ad = JAutoDist(strategy_builder=JAllReduce(), mesh_axes={"data": 8})
    with ad.scope():
        ad.capture(params=params, optimizer=optax.adam(1e-2),
                   loss_fn=jspec.loss_fn)
    sess = ad.create_distributed_session()
    want = [float(sess.run(batch)["loss"]) for _ in range(worker.STEPS)]
    jax_reset()
    return params, batch, want


def _losses(params, batch, remat, steps=worker.STEPS):
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params), optimizer=optim.adam(1e-2),
                   loss_fn=spec.loss_fn, remat=remat)
    sess = ad.create_distributed_session()
    return [float(sess.run(batch)["loss"]) for _ in range(steps)]


@pytest.fixture(scope="module")
def plain_losses(problem):
    params, batch, _ = problem
    return _losses(params, batch, None)


def test_plain_run_matches_the_jax_session(problem, plain_losses):
    np.testing.assert_allclose(plain_losses, problem[2], rtol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_plain(problem, plain_losses, policy):
    params, batch, _ = problem
    np.testing.assert_allclose(_losses(params, batch, policy), plain_losses,
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def gloo(problem, tmp_path_factory):
    """One launch of a 2-rank gloo pair in ``levers`` mode on the remat
    problem: both ranks' outputs."""
    params, batch, _ = problem
    tmp = tmp_path_factory.mktemp("remat")
    data = tmp / "in.npz"
    np.savez(data, **{f"remat/p/{n}": x for n, x in flatten(params)},
             **{"remat/b/tokens": batch["tokens"]})
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init, tmp / f"rank{rank}.npz",
                            "levers", data],
        world=2, tmp_dir=tmp, timeout=240)
    return [np.load(tmp / f"rank{r}.npz") for r in range(2)]


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_remat_on_two_gloo_ranks_matches_jax(problem, plain_losses, gloo,
                                             policy):
    """2 gloo ranks under each policy: the JAX 8-device session's losses
    at rtol 1e-5, and the port's one-rank losses without remat at 1e-6."""
    for out in gloo:
        got = out[f"remat/{policy}"]
        np.testing.assert_allclose(got, problem[2], rtol=1e-5)
        np.testing.assert_allclose(got, plain_losses, rtol=1e-6, atol=1e-6)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        GraphItem({"w": torch.zeros(2)}, loss_fn=lambda p, b: 0.0,
                  remat="bogus")
    with pytest.raises(ValueError, match="expected 'none', 'full', or "
                                         "'dots'"):
        transformer_lm(**LEVER_CFG, remat="dots_no_batch")


def _value_and_grads(spec, params, batch):
    leaves = {n: t.detach().clone().requires_grad_()
              for n, t in flatten(params)}
    tree = {}
    for name, t in leaves.items():
        node = tree
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    loss = spec.loss_fn(tree, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_is_gradient_invisible(remat, attention):
    """``transformer_lm(remat=)`` against the model without remat on the
    same weights: the same loss, gradients at rtol 1e-6 / atol 1e-7; with
    dense attention (the JAX test's) and with the flash path's operator
    (its plain version on the CPU)."""
    attn = flash_attention if attention == "flash" else None
    base = transformer_lm(**LEVER_CFG, attn_fn=attn)
    ckpt = transformer_lm(**LEVER_CFG, attn_fn=attn, remat=remat)
    jspec = jax_lm(**LEVER_CFG, attn_fn=jax_dense)
    params = params_from_jax(jax.tree.map(
        np.asarray, jspec.init(jax.random.PRNGKey(0))))
    batch = jspec.sample_batch(4)
    l0, g0 = _value_and_grads(base, params, batch)
    l1, g1 = _value_and_grads(ckpt, params, batch)
    assert l0 == l1
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    # and the JAX package's remat model on the same weights: the loss at
    # rtol 1e-5, the gradients at the flash kernels' 1e-4
    jckpt = jax_lm(**LEVER_CFG, attn_fn=jax_dense, remat=remat)
    jl, jg = jax.value_and_grad(jckpt.loss_fn)(
        jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0))), batch)
    np.testing.assert_allclose(l1, float(jl), rtol=1e-5)
    for name, want in flatten(jax.tree.map(np.asarray, jg)):
        np.testing.assert_allclose(g1[name].numpy(), want, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_remat_composes_with_session():
    """A ``remat="dots"`` model trains through the facade, at rtol 1e-5 of
    the JAX package's same run (6 ``adam(1e-2)`` steps)."""
    jspec = jax_lm(**LEVER_CFG, attn_fn=jax_dense, remat="dots")
    params = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    batch = jspec.sample_batch(8)
    jax_reset()
    jad = JAutoDist(strategy_builder=JAllReduce())
    with jad.scope():
        jad.capture(params=params, optimizer=optax.adam(1e-2),
                    loss_fn=jspec.loss_fn)
    jsess = jad.create_distributed_session()
    want = [float(jsess.run(jsess.place_batch(batch))["loss"])
            for _ in range(6)]
    spec = transformer_lm(**LEVER_CFG, remat="dots")
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params), optimizer=optim.adam(1e-2),
                   loss_fn=spec.loss_fn)
    sess = ad.create_distributed_session()
    losses = [float(sess.run(batch)["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, want, rtol=1e-5)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_dots_policies_keep_the_matmul_outputs(policy):
    """What each ``dots`` policy keeps on the CPU: every projection of the
    LM (six per layer) is an ``aten.mm``; dense attention's two products
    per layer and the tied head are ``aten.bmm``, kept by ``dots`` only;
    everything else is recomputed.  The flash operator is recomputed by
    both."""
    saved = _REMAT_POLICIES[policy]
    seen = {"kept": {}, "recomputed": set()}

    def policy_fn(ctx, op, *args, **kwargs):
        if ctx.is_recompute:
            return CheckpointPolicy.PREFER_RECOMPUTE
        if op in saved:
            seen["kept"][str(op)] = seen["kept"].get(str(op), 0) + 1
            return CheckpointPolicy.MUST_SAVE
        seen["recomputed"].add(str(op))
        return CheckpointPolicy.PREFER_RECOMPUTE

    layers = LEVER_CFG["num_layers"]
    for attn, bmm in ((None, 2 * layers + 1), (flash_attention, 1)):
        seen = {"kept": {}, "recomputed": set()}
        spec = transformer_lm(**LEVER_CFG, attn_fn=attn)
        params = spec.init(0, device="cpu")
        for leaf in (t for _, t in flatten(params)):
            leaf.requires_grad_()
        checkpoint(spec.loss_fn, params, spec.sample_batch(2),
                   use_reentrant=False,
                   context_fn=lambda: create_selective_checkpoint_contexts(
                       policy_fn)).backward()
        want = {"aten.mm.default": 6 * layers}
        if policy == "dots":
            want["aten.bmm.default"] = bmm
        assert seen["kept"] == want
        assert ("autodist_tpu_torch.flash_fwd.default" in seen["recomputed"]) \
            == (attn is not None)


def _jax_flash_kernels(jaxpr, counts):
    """Count the JAX flash kernels' ``pallas_call``s in ``jaxpr`` and its
    sub-jaxprs: the forward (outputs o and lse ``[..., 1]``), dQ (one
    output) and dK/dV (two outputs of one shape)."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            avals = eqn.params["out_avals"]
            kind = "dq" if len(avals) == 1 else \
                "fwd" if avals[1].shape[-1] == 1 else "dkv"
            counts[kind] = counts.get(kind, 0) + 1
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else (param,):
                if isinstance(sub, ClosedJaxpr):
                    _jax_flash_kernels(sub.jaxpr, counts)
                elif isinstance(sub, Jaxpr):
                    _jax_flash_kernels(sub, counts)
    return counts


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_backward_runs_the_flash_forward_again_as_jax_does(remat):
    """Under ``full`` and ``dots`` the backward recomputes the flash
    forward once per layer, in the JAX package (its gradient's jaxpr
    holds two forward ``pallas_call``s per layer: ``checkpoint_dots``
    keeps dots, and a ``pallas_call`` is none) and in the port (the
    registered K1 operator dispatches twice per layer in one forward and
    backward); dQ and dK/dV run once per layer in both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    layers = LEVER_CFG["num_layers"]
    jspec = jax_lm(**LEVER_CFG, remat=remat, attn_fn=jax_flash(
        block_q=8, block_k=8, interpret=True))
    jparams = jspec.init(jax.random.PRNGKey(0))
    batch = jspec.sample_batch(2)
    jaxpr = jax.make_jaxpr(jax.grad(jspec.loss_fn))(jparams, batch)
    fwd = layers * (1 if remat == "none" else 2)
    assert _jax_flash_kernels(jaxpr.jaxpr, {}) == {"fwd": fwd, "dq": layers,
                                                   "dkv": layers}

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func) == "autodist_tpu_torch.flash_fwd.default":
                Count.calls += 1
            return func(*args, **(kwargs or {}))

    spec = transformer_lm(**LEVER_CFG, remat=remat, attn_fn=flash_attention)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    for _, leaf in flatten(params):
        leaf.requires_grad_()
    with Count():
        spec.loss_fn(params, batch).backward()
    assert Count.calls == fwd
