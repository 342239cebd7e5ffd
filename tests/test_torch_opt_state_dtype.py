"""bf16 optimizer state in the port against the JAX package:
``ops.opt_state_dtype.cast_opt_state`` (``tests/test_mfu_levers.py``'s and
``tests/test_zero1.py::test_zero1_composes_with_bf16_moments``' twins), on
the tree layout and on the ZeRO-1 bucket shards, on one rank and on 2 gloo
ranks, through the Saver and the JAX state converter, and the fused Adam
kernel's (K5's) selection for a wrapped optimizer.

The trajectory is held against JAX's ``cast_opt_state(optax.adam)`` at
rtol 1e-5 (both round the moments to nearest even every step), and
against the f32-state run at the JAX test's rtol 0.1.
"""
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu.ops.opt_state_dtype import cast_opt_state as jax_cast
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import (AutoDist,
                                         _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.convert import opt_state_from_jax, params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.ops.opt_state_dtype import (_cast_state,
                                                    cast_opt_state,
                                                    default_cast_rule)
from autodist_tpu_torch.strategy import AllReduce, Zero1

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
sys.path.insert(0, str(WORKER.parent))
import torch_launch  # noqa: E402


@pytest.fixture(autouse=True)
def _testing_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_IS_TESTING", "True")
    _reset_default_autodist_for_testing()


def _dtypes(state):
    """``{dtype name}`` of the non-scalar floating leaves, and of the
    integer leaves."""
    leaves = [v for _, v in flatten(state)]
    return ({str(v.dtype) for v in leaves if default_cast_rule(v)},
            {str(v.dtype) for v in leaves if not v.is_floating_point()})


def _least_squares():
    """``tests/test_mfu_levers.py``'s problem."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    w_true = rng.randn(8, 4).astype(np.float32)
    return {"x": x, "y": x @ w_true}


def _jax_losses(opt, batch, steps):
    params = {"w": jnp.zeros((8, 4)), "b": jnp.zeros((4,))}

    def loss_fn(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p, batch)
        u, s = opt.update(g, s, p)
        return loss, optax.apply_updates(p, u), s

    state, losses = opt.init(params), []
    for _ in range(steps):
        loss, params, state = step(params, state)
        losses.append(float(loss))
    return losses, state


def _port_losses(opt, batch, steps, in_place):
    """``steps`` of least squares with ``opt``: functional ``update`` +
    ``apply_updates``, or the in-place ``step_`` the training step runs."""
    params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    x, y = (torch.from_numpy(batch[k]) for k in ("x", "y"))
    state, losses = opt.init(params), []
    for _ in range(steps):
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = ((x @ p["w"] + p["b"] - y) ** 2).mean()
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        if in_place:
            opt.step_(params, g, state)
        else:
            u, state = opt.update(g, state, params)
            params = optim.apply_updates(params, u)
    return losses, state


@pytest.mark.parametrize("in_place", [False, True], ids=["update", "step_"])
def test_bf16_opt_state_dtype_and_convergence(in_place):
    """bf16 moments and an int32 count; the trajectory of JAX's
    ``cast_opt_state(optax.adam(0.05))`` at rtol 1e-5 for 20 steps; the
    f32-state trajectory at the JAX test's rtol 0.1; convergence."""
    batch = _least_squares()
    f32, _ = _port_losses(optim.adam(0.05), batch, 80, in_place)
    bf16, state = _port_losses(cast_opt_state(optim.adam(0.05)), batch, 80,
                               in_place)
    assert _dtypes(state) == ({"torch.bfloat16"}, {"torch.int32"})
    jbf16, jstate = _jax_losses(jax_cast(optax.adam(0.05)), batch, 20)
    np.testing.assert_allclose(bf16[:20], jbf16, rtol=1e-5)
    np.testing.assert_allclose(bf16[:20], f32[:20], rtol=0.1)
    assert bf16[-1] < bf16[0] * 1e-3
    # the JAX state after 20 steps carries across with its dtypes
    _, state20 = _port_losses(cast_opt_state(optim.adam(0.05)), batch, 20,
                              in_place)
    carried = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert _dtypes(carried) == _dtypes(state20)
    for name, want in flatten(carried):
        np.testing.assert_allclose(dict(flatten(state20))[name].float(),
                                   want.float(), rtol=1e-2, atol=1e-6)


def test_cast_rule_passes_scalars_and_integers():
    state = {"count": torch.zeros((), dtype=torch.int32),
             "scale": torch.ones(()), "mu": {"w": torch.ones(3)}}
    cast = _cast_state(state, torch.bfloat16)
    assert (cast["count"].dtype, cast["scale"].dtype, cast["mu"]["w"].dtype) \
        == (torch.int32, torch.float32, torch.bfloat16)
    wide = cast_opt_state(optim.adam(1e-2), torch.float32).init(
        {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert wide["mu"]["w"].dtype == torch.float32


def _lm_session(opt, builder=None, **capture):
    spec = transformer_lm(vocab_size=61, num_layers=1, num_heads=2,
                          head_dim=8, d_ff=32, max_len=16, seq_len=16)
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder or AllReduce(), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"), optimizer=opt,
                   loss_fn=spec.loss_fn, **capture)
    return ad.create_distributed_session(), spec.sample_batch(8)


@pytest.mark.parametrize("builder", ["AllReduce", "Zero1"])
def test_bf16_opt_state_through_session_and_checkpoint(tmp_path, builder):
    """The narrow state composes with the session (the tree layout under
    ``AllReduce``, the bucket shards under ``Zero1``) and survives a
    Saver round trip with its dtypes: the steps after the restore repeat
    the steps after the save."""
    sess, batch = _lm_session(cast_opt_state(optim.adamw(1e-2)),
                              AllReduce() if builder == "AllReduce"
                              else Zero1())
    l0 = float(sess.run(batch)["loss"])
    assert _dtypes(sess.opt_state) == ({"torch.bfloat16"}, {"torch.int32"})
    saver = Saver(sess)
    path = saver.save(str(tmp_path / "ck"), step=sess.step_count)
    after_save = [float(sess.run(batch)["loss"]) for _ in range(2)]
    saver.restore(path)
    assert _dtypes(sess.opt_state) == ({"torch.bfloat16"}, {"torch.int32"})
    after_restore = [float(sess.run(batch)["loss"]) for _ in range(2)]
    assert after_restore == after_save
    assert after_save[-1] < l0


def _zero1_problem():
    """``tests/test_zero1.py``'s problem, as numpy."""
    rng = np.random.RandomState(0)
    params = {"l1": {"w": (rng.randn(32, 48) * 0.1).astype(np.float32),
                     "b": np.zeros(48, np.float32)},
              "l2": {"w": (rng.randn(48, 4) * 0.1).astype(np.float32)}}
    batch = {"x": rng.randn(16, 32).astype(np.float32),
             "y": rng.randn(16, 4).astype(np.float32)}
    return params, batch


def _zero1_loss(p, b):
    h = torch.tanh(b["x"] @ p["l1"]["w"] + p["l1"]["b"])
    return ((h @ p["l2"]["w"] - b["y"]) ** 2).mean()


def _state_bytes(state):
    return sum(v.numel() * v.element_size() for _, v in flatten(state))


def test_zero1_composes_with_bf16_moments():
    """``cast_opt_state`` under ``Zero1``: the state's bytes under 0.7x of
    the f32 state's, the losses falling under 0.2x in 30 steps."""
    params, batch = _zero1_problem()
    sessions = {}
    for name, opt in (("f32", optim.adam(1e-2)),
                      ("bf16", cast_opt_state(optim.adam(1e-2)))):
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=Zero1(), device="cpu")
        with ad.scope():
            ad.capture(params=params_from_jax(params), optimizer=opt,
                       loss_fn=_zero1_loss)
        sessions[name] = ad.create_distributed_session()
    z16 = sessions["bf16"]
    assert z16.zero1_buckets
    assert _state_bytes(z16.opt_state) \
        < 0.7 * _state_bytes(sessions["f32"].opt_state)
    losses = [float(z16.run(batch)["loss"]) for _ in range(30)]
    assert losses[-1] < losses[0] * 0.2


def test_jax_zero1_bf16_state_continues_in_the_port():
    """A JAX ``Zero1()`` session with ``cast_opt_state(optax.adam)``: its
    state after 2 steps (bf16 moments as full bucket vectors, ml_dtypes
    arrays) converts into the port's ZeRO-1 shards as bf16 with an int32
    count, and 3 more steps match the JAX session's at rtol 1e-5."""
    from autodist_tpu.autodist import AutoDist as JAutoDist
    from autodist_tpu.autodist import \
        _reset_default_autodist_for_testing as jax_reset
    from autodist_tpu.strategy import Zero1 as JZero1

    params, batch = _zero1_problem()

    def jloss(p, b):
        h = jnp.tanh(b["x"] @ p["l1"]["w"] + p["l1"]["b"])
        return jnp.mean((h @ p["l2"]["w"] - b["y"]) ** 2)

    jax_reset()
    jad = JAutoDist(strategy_builder=JZero1())
    with jad.scope():
        jad.capture(params=params, optimizer=jax_cast(optax.adam(1e-2)),
                    loss_fn=jloss)
    jsess = jad.create_distributed_session()
    for _ in range(2):
        jsess.run(batch)
    jparams, jopt = jax.tree.map(np.asarray, jsess.export_state())
    want = [float(jsess.run(batch)["loss"]) for _ in range(3)]
    jax_reset()

    ad = AutoDist(strategy_builder=Zero1(), device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=cast_opt_state(optim.adam(1e-2)),
                   loss_fn=_zero1_loss)
    sess = ad.create_distributed_session()
    state = opt_state_from_jax(jopt, zero1_buckets=sess.zero1_buckets)
    assert _dtypes(state) == ({"torch.bfloat16"}, {"torch.int32"})
    sess.import_state(params_from_jax(jparams), state, step=2)
    assert _dtypes(sess.opt_state) == ({"torch.bfloat16"}, {"torch.int32"})
    np.testing.assert_allclose([float(sess.run(batch)["loss"])
                                for _ in range(3)], want, rtol=1e-5)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """One launch of a 2-rank gloo pair in ``levers`` mode on the ZeRO-1
    problem: both ranks' outputs."""
    params, batch = _zero1_problem()
    tmp = tmp_path_factory.mktemp("bf16_state")
    data = tmp / "in.npz"
    np.savez(data, **{f"zero1/p/{n}": x for n, x in flatten(params)},
             **{f"zero1/b/{k}": x for k, x in batch.items()})
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init, tmp / f"rank{rank}.npz",
                            "levers", data],
        world=2, tmp_dir=tmp, timeout=240)
    return [np.load(tmp / f"rank{r}.npz") for r in range(2)]


def test_zero1_bf16_moments_on_two_gloo_ranks(gloo):
    """On 2 gloo ranks each rank holds half of every bucket's moments in
    bf16 (the levers multiply: under 0.7x of the f32 shards' bytes), the
    count stays int32, the losses are the same on both ranks and fall
    under 0.2x, and they track the f32-state run at rtol 0.1."""
    for out in gloo:
        assert sorted(out["zero1/bf16/dtypes"]) == ["0:torch.int32",
                                                    "1:torch.bfloat16"]
        assert out["zero1/bf16/bytes"] < 0.7 * out["zero1/f32/bytes"]
        losses = out["zero1/bf16/losses"]
        assert losses[-1] < losses[0] * 0.2
        np.testing.assert_allclose(losses[:10], out["zero1/f32/losses"][:10],
                                   rtol=0.1)
    np.testing.assert_array_equal(gloo[0]["zero1/bf16/losses"],
                                  gloo[1]["zero1/bf16/losses"])


def test_wrapped_fusable_adam_takes_the_unfused_shard_update():
    """``cast_opt_state(fusable_adam(...))`` carries no ``fused_spec``, as
    in the JAX package, so the ZeRO-1 shards drop K5 with the
    ``optimizer_fusable`` reason; K4 (the guard) still runs.  A bf16
    gradient bucket under a bare ``fusable_adam`` drops it with the
    ``f32_buckets`` reason (the ``bf16_remat`` case's)."""
    assert getattr(jax_cast(jfk.fusable_adam(1e-2)), "fused_spec",
                   None) is None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sess, batch = _lm_session(cast_opt_state(fk.fusable_adam(1e-2)),
                                  Zero1(), numerics={"clip_norm": 1.0})
    why = fk.fused_drop_reason(fk.KERNEL_UPDATE, optimizer_fusable=False)
    assert any(why in str(w.message) for w in caught)
    assert sess._step.fused_kernels == (fk.KERNEL_GUARD,)
    assert np.isfinite(float(sess.run(batch)["loss"]))

    params = {"l1": {"w": torch.full((8, 16), 0.1, dtype=torch.bfloat16)}}
    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=Zero1(), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with ad.scope():
            ad.capture(params=params, optimizer=fk.fusable_adam(1e-2),
                       loss_fn=lambda p, b: (b["x"] @ p["l1"]["w"]).float()
                       .square().mean(), remat="dots")
        sess = ad.create_distributed_session()
    why = fk.fused_drop_reason(fk.KERNEL_UPDATE, f32_buckets=False)
    assert why == fk.fused_drop_reason(
        fk.KERNEL_UPDATE, optimizer_fusable=True, f32_buckets=False)
    assert any(why in str(w.message) for w in caught)
    assert fk.KERNEL_UPDATE not in sess._step.fused_kernels
    sess.run({"x": torch.ones(4, 8, dtype=torch.bfloat16)})
    assert sess.opt_state["zero1"]["mu"][
        sess.zero1_buckets[0].key].dtype == torch.bfloat16
