"""K4 (guard statistics) and K5 (fused ZeRO-1 Adam update) of the port
against the JAX package's Pallas kernels in interpret mode.

Inputs come from numpy with a seed and go to both sides.  Tolerances: the
sum of squares at rtol 1e-6 (f32, another summation order), the
non-finite count and the finite bit exactly; K5 at atol 1e-6 over three
steps (the JAX kernel test's, ``tests/test_fused_kernels.py:89-116``).
On the CPU the wrappers run their plain versions and count no launch.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.kernel.synchronization.bucketing import \
    assign_buckets as jax_assign_buckets
from autodist_tpu.kernel.synchronization.bucketing import \
    pack_bucket as jax_pack_bucket
from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu_torch import optim
from autodist_tpu_torch.kernel.synchronization.bucketing import (
    assign_buckets, pack_bucket)
from autodist_tpu_torch.ops import fused_kernels as fk

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("n", [7, 256, 10_001, 16_384])
def test_detect_stats_matches_jax(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jnf, jsq = jfk.fused_detect_stats(jnp.asarray(x), interpret=True)
    nf, sq = fk.fused_detect_stats(torch.from_numpy(x))
    assert float(nf) == float(jnf) == 0.0
    assert nf.dtype == sq.dtype == torch.float32 and nf.shape == ()
    np.testing.assert_allclose(float(sq), float(jsq), rtol=1e-6)


@pytest.mark.parametrize("poison", [None, np.nan, np.inf, -np.inf])
def test_detect_stats_finite_bit_matches_jax(poison):
    x = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    if poison is not None:
        x[137] = poison
    jnf, jsq = jfk.fused_detect_stats(jnp.asarray(x), interpret=True)
    nf, sq = fk.fused_detect_stats(torch.from_numpy(x))
    assert float(nf) == float(jnf) == (0.0 if poison is None else 1.0)
    assert np.isfinite(float(sq)) == np.isfinite(float(jsq)) \
        == (poison is None)


def test_pack_detect_is_pack_plus_stats_as_in_jax():
    entries = [("a", (32, 8), "float32", "NoneCompressor", 0, "all_reduce"),
               ("b", (100,), "float32", "NoneCompressor", 0, "all_reduce")]
    (b,) = assign_buckets(entries, shard_divisor=8)
    (jb,) = jax_assign_buckets(entries, shard_divisor=8)
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal((32, 8)).astype(np.float32),
              rng.standard_normal(100).astype(np.float32)]
    vec, nf, sq = fk.fused_pack_detect(b, [torch.from_numpy(x)
                                           for x in leaves])
    jvec = jax_pack_bucket(jb, [jnp.asarray(x) for x in leaves])
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    torch.testing.assert_close(pack_bucket(b, [torch.from_numpy(x)
                                               for x in leaves]), vec)
    want_nf, want_sq = fk.fused_detect_stats(vec)
    assert float(nf) == float(want_nf) == 0.0
    assert float(sq) == float(want_sq)


@pytest.mark.parametrize("mult_val", [1.0, 0.25])
def test_fused_adam_matches_jax_kernel(mult_val):
    """Three steps of K5's plain version against the JAX kernel in
    interpret mode, the shared step counter advancing."""
    spec, jspec = fk.AdamSpec(lr=1e-3), jfk.AdamSpec(lr=1e-3)
    rng = np.random.default_rng(7)
    n = 3000
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    jp, jmu, jnu = jnp.asarray(p0), jnp.zeros(n), jnp.zeros(n)
    p = torch.from_numpy(p0.copy())
    mu, nu = torch.zeros(n), torch.zeros(n)
    for step, g in enumerate(grads):
        jp, jmu, jnu = jfk.fused_adam_update(
            jp, jnp.asarray(g), jmu, jnu, jnp.int32(step), jspec,
            mult=jnp.float32(mult_val), interpret=True)
        p, mu, nu = fk.fused_adam_update(
            p, torch.from_numpy(g), mu, nu,
            fk.adam_scalars(torch.tensor(step, dtype=torch.int32), spec,
                            torch.tensor(mult_val)), spec)
        for got, want, name in ((p, jp, "p"), (mu, jmu, "mu"),
                                (nu, jnu, "nu")):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} at step {step}")


@pytest.mark.parametrize("count", [0, 4, 999])
def test_adam_scalars_are_the_jax_kernels(count):
    """``[mult, 1 - b1^(count+1), 1 - b2^(count+1)]`` in f32, as the JAX
    wrapper computes them; ``mult`` None is 1."""
    spec = fk.AdamSpec(lr=1e-2, b1=0.8, b2=0.99, eps=1e-6)
    c = jnp.float32(count + 1)
    want = [0.5, 1.0 - jnp.float32(spec.b1) ** c,
            1.0 - jnp.float32(spec.b2) ** c]
    got = fk.adam_scalars(torch.tensor(count, dtype=torch.int32), spec,
                          torch.tensor(0.5))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=1e-7)
    assert float(fk.adam_scalars(torch.tensor(count), spec)[0]) == 1.0


def test_fusable_adam_behaves_like_adam():
    rng = np.random.default_rng(9)
    tree = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(
        np.float32)), "b": torch.zeros(3)}
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in tree.items()} for _ in range(3)]
    fused, plain = fk.fusable_adam(1e-2), optim.adam(1e-2)
    pa = {k: v.clone() for k, v in tree.items()}
    pb = {k: v.clone() for k, v in tree.items()}
    sa, sb = fused.init(pa), plain.init(pb)
    for g in grads:
        fused.step_(pa, dict(g), sa)
        plain.step_(pb, dict(g), sb)
    for k in tree:
        assert torch.equal(pa[k], pb[k])
        assert torch.equal(sa["mu"][k], sb["mu"][k])
    assert fused.fused_spec == fk.AdamSpec(lr=1e-2)
    assert getattr(plain, "fused_spec", None) is None
    # the JAX twin carries the same hyperparameters
    assert tuple(fused.fused_spec) == tuple(jfk.fusable_adam(1e-2).fused_spec)


def test_adam_state_probe_and_replace():
    state = fk.fusable_adam(1e-3).init({"x": torch.zeros(3)})
    assert fk.find_adam_state(state) is state
    assert fk.find_adam_state(optim.sgd(0.1, momentum=0.9).init(
        {"x": torch.zeros(3)})) is None
    assert fk.find_adam_state({}) is None
    new = fk.replace_adam_state(state, {"count": state["count"] + 1,
                                        "mu": {"x": torch.ones(3)},
                                        "nu": state["nu"]})
    assert int(new["count"]) == 1 and torch.equal(new["mu"]["x"],
                                                   torch.ones(3))
    assert int(state["count"]) == 0
    with pytest.raises(ValueError):
        fk.replace_adam_state({}, new)
    # JAX's probe finds the same three entries in the optimizer library's
    jstate = optax.adam(1e-3).init({"x": jnp.zeros(3)})
    assert set(jfk.find_adam_state(jstate)._fields) == set(state)


def test_wrappers_on_cpu_count_no_launch_and_refuse_other_dtypes():
    before = (fk.fused_detect_stats.calls, fk.fused_adam_update.calls)
    x = torch.randn(10)
    fk.fused_detect_stats(x)
    fk.fused_adam_update(x, x, x, x.abs(), torch.ones(3), fk.AdamSpec(1.0))
    assert (fk.fused_detect_stats.calls, fk.fused_adam_update.calls) \
        == before
    for bad in (torch.randn(10, dtype=torch.float64),
                torch.randn(10).bfloat16()):
        with pytest.raises(TypeError):
            fk.fused_detect_stats(bad)
        with pytest.raises(TypeError):
            fk.fused_adam_update(bad, bad, bad, bad, torch.ones(3),
                                 fk.AdamSpec(1.0))
    with pytest.raises(ValueError):
        fk.fused_detect_stats(torch.randn(4, 4).t())
    with pytest.raises(ValueError):
        fk.fused_adam_update(x, x[:5], x, x, torch.ones(3),
                             fk.AdamSpec(1.0))
    with pytest.raises(ValueError):
        fk.fused_adam_update(x, x, x, x, torch.ones(2), fk.AdamSpec(1.0))


@pytest.mark.parametrize("fusable,adam_shaped,f32,reason", [
    (True, True, True, None), (False, True, True, "fusable_adam"),
    (True, False, True, "Adam-shaped"), (True, True, False, "float32")])
def test_fused_drop_reason_is_the_jax_rule_without_platform(
        fusable, adam_shaped, f32, reason):
    kw = dict(optimizer_fusable=fusable, adam_state_shaped=adam_shaped,
              f32_buckets=f32)
    why = fk.fused_drop_reason(fk.KERNEL_UPDATE, **kw)
    jwhy = jfk.fused_drop_reason(jfk.KERNEL_UPDATE, on_tpu=True, **kw)
    assert (why is None) == (jwhy is None)
    if reason is not None:
        assert reason in why
    active, drops = fk.resolve_fused(guard=True, has_rs=True, **kw)
    assert fk.KERNEL_GUARD in active
    assert (fk.KERNEL_UPDATE in active) == (reason is None)
    assert [k for k, _ in drops] == ([] if reason is None
                                     else [fk.KERNEL_UPDATE])
    assert fk.resolve_fused(guard=False, has_rs=False, **kw) == ((), [])
