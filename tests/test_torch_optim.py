"""The port's optimizers against the JAX package's optimizer library.

Five steps on a random tree with random gradients (numpy-seeded, shared by
both sides), through the functional ``update`` + ``apply_updates`` and
through the in-place ``step_`` the training step runs.  Tolerance 1e-6
(float32 rounding; the same expression order on both sides), on the
parameters and on the state.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu_torch import optim
from autodist_tpu_torch.convert import (opt_state_from_jax,
                                        opt_state_to_numpy, params_from_jax,
                                        params_to_numpy)
from autodist_tpu_torch.graph_item import flatten

pytestmark = pytest.mark.torch_port

OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1), lambda: optim.sgd(0.1)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: optim.sgd(0.1, momentum=0.9)),
    "sgd_nesterov": (lambda: optax.sgd(0.1, momentum=0.9, nesterov=True),
                     lambda: optim.sgd(0.1, momentum=0.9, nesterov=True)),
    "adam": (lambda: optax.adam(1e-2), lambda: optim.adam(1e-2)),
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=0.1),
              lambda: optim.adamw(1e-2, weight_decay=0.1)),
}


def _tree(rng):
    return {"dense": {"kernel": rng.standard_normal((4, 3)).astype(
        np.float32), "bias": rng.standard_normal(3).astype(np.float32)},
        "embed": rng.standard_normal((5, 2)).astype(np.float32) * 1e-3}


def _grads(rng, steps):
    return [_tree(rng) for _ in range(steps)]


def _close(got, want):
    for (n, a), (m, b) in zip(flatten(got), flatten(want)):
        assert n == m
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=n)


def _jax_run(make, params, grads):
    opt = make()
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_matches_the_jax_library_over_five_steps(name):
    jmake, make = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params0, grads = _tree(rng), _grads(rng, 5)
    jparams, jstate = _jax_run(jmake, params0, grads)

    opt = make()
    params = params_from_jax(params0)
    state = opt.init(params)
    for g in grads:
        updates, state = opt.update(params_from_jax(g), state, params)
        params = optim.apply_updates(params, updates)
    _close(params_to_numpy(params), jparams)
    _close(opt_state_to_numpy(state),
           opt_state_to_numpy(opt_state_from_jax(jstate)))

    # the in-place step the training step runs gives the same numbers
    params = params_from_jax(params0)
    state = opt.init(params)
    for g in grads:
        opt.step_(params, dict(flatten(params_from_jax(g))), state)
    _close(params_to_numpy(params), jparams)
    _close(opt_state_to_numpy(state),
           opt_state_to_numpy(opt_state_from_jax(jstate)))


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd_momentum", "sgd"])
def test_state_carried_from_jax_continues_the_trajectory(name):
    """Two JAX steps, carry params and state over, one more step on each
    side."""
    jmake, make = OPTIMIZERS[name]
    rng = np.random.default_rng(1)
    params0, grads = _tree(rng), _grads(rng, 3)
    jparams, jstate = _jax_run(jmake, params0, grads[:2])
    want_params, want_state = _jax_run(jmake, params0, grads)

    state = opt_state_from_jax(jstate)
    if "count" in state:
        assert int(state["count"]) == 2
    params = params_from_jax(jparams)
    make().step_(params, dict(flatten(params_from_jax(grads[2]))), state)
    _close(params_to_numpy(params), want_params)
    _close(opt_state_to_numpy(state),
           opt_state_to_numpy(opt_state_from_jax(want_state)))


def test_update_is_functional():
    opt = optim.adam(1e-2)
    params = params_from_jax(_tree(np.random.default_rng(2)))
    state = opt.init(params)
    before = {n: x.clone() for n, x in flatten(state["mu"])}
    opt.update(params, state, params)
    assert int(state["count"]) == 0
    for n, x in flatten(state["mu"]):
        assert torch.equal(x, before[n])


def test_unsupported_jax_state_is_refused():
    multi = optax.multi_transform(
        {"a": optax.adam(1e-3), "b": optax.set_to_zero()},
        {"w": "a", "v": "b"})
    state = multi.init({"w": np.zeros(2, np.float32),
                        "v": np.zeros(2, np.float32)})
    with pytest.raises(ValueError):
        opt_state_from_jax(jax.tree.map(np.asarray, state))
