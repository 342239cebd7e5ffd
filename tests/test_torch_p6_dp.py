"""The P6 options on 2 gloo ranks against the JAX package on a 2-device
CPU mesh (``tests/torch_dp_worker.py`` mode ``p6``, one launch).

* the cast and low-rank compressors' ``reduce`` / ``reduce_scatter``
  against the JAX compressors under ``shard_map`` on the same rows;
  their sessions on ``tests/test_compressors.py``'s least squares against
  the JAX sessions (PowerSGD from the JAX session's basis, carried by
  ``convert.sync_state_from_jax``), and their convergence, error feedback
  not worse than the plain cast (``:102-140``);
* Program E (``__graft_entry__.py:233-280``): the bf16+EF wire with fused
  groups and ``accum_steps=2`` at rtol 5e-3 of the uncompressed run, and
  fused groups' buckets and losses against the JAX session's;
* bounded staleness and proxy variables exactly against the closed-form
  delayed-gradient oracle (``tests/test_stale_sync.py:82-166``,
  Program F);
* the accumulation pipeline on the small LM: even microbatches against
  the JAX pipeline, the uneven tail against the JAX and the port's
  ``overlap="none"`` (the JAX pipelined uneven tail fails its own tests);
  ``Int8Compressor`` per slot under ``"pipeline"`` and ``"full"``.

Tolerances: bf16 sums at 2 ranks are one rounding, so both packages agree
to f32 summation order (rtol 1e-5) unless stated; LM parameters at atol
1e-4 (``tests/test_torch_training.py``).
"""
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from autodist_tpu.autodist import AutoDist as JAutoDist
from autodist_tpu.autodist import \
    _reset_default_autodist_for_testing as jax_reset
from autodist_tpu.graph_item import GraphItem as JGraphItem
from autodist_tpu.kernel.synchronization import explicit_sync as jes
from autodist_tpu.kernel.synchronization.compressor import \
    get_compressor as jget_compressor
from autodist_tpu.mesh import build_mesh as jax_build_mesh
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import PS as JPS
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import Zero1 as JZero1
from autodist_tpu.utils import compat
from autodist_tpu_torch.convert import params_to_numpy, sync_state_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.models.transformer_lm import transformer_lm

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker as worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"


def spawn_p6(n, tmp_path, psgd_sync):
    """One launch of ``n`` gloo ranks in ``p6`` mode; every rank's npz."""
    inputs = worker.p6_inputs(n)
    inputs["q"] = np.random.RandomState(1).randn(5, 1).astype(np.float32)
    inputs["psgd"] = {r: sync_state_from_jax(psgd_sync, rank=r)
                      for r in range(n)}
    infile = tmp_path / "p6in.pt"
    torch.save(inputs, infile)
    torch_launch.run(
        lambda r, init: [WORKER, r, n, init, tmp_path / f"rank{r}.npz",
                         "p6", infile],
        world=n, tmp_dir=tmp_path, timeout=300,
        env={"AUTODIST_PROXY_REFRESH": None, "AUTODIST_DCN_WIRE": None})
    return inputs, [dict(np.load(tmp_path / f"rank{r}.npz"))
                    for r in range(n)]


def jax_mesh(n):
    return jax_build_mesh({"data": n}, devices=jax.devices()[:n])


def jax_session(n, builder, params, loss, opt, accum=1, info=None,
                **capture):
    """The JAX facade's session on an ``n``-device data mesh."""
    jax_reset()
    spec = JResourceSpec(resource_info=info) if info else None
    ad = JAutoDist(strategy_builder=builder, resource_spec=spec)
    with ad.scope():
        ad.capture(params=params, optimizer=opt, loss_fn=loss,
                   accum_steps=accum, **capture)
    return ad.create_distributed_session(mesh=jax_mesh(n))


def jax_lin_loss(p, b):
    return jnp.mean((b["x"] @ p["linear"]["w"] + p["linear"]["b"]
                     - b["y"]) ** 2)


def jax_prog_e_loss(p, b):
    return jnp.mean((jnp.tanh(b["x"] @ p["w1"]) @ p["w2"] + p["b"]
                     - b["y"]) ** 2)


def jax_stale_loss(p, b):
    return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)


def jax_unit(n, fn, *arrays):
    """``fn`` on each of ``n`` devices' rows of ``arrays`` under
    ``shard_map``; every output stacked ``[n, ...]``."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def body(*xs):
        return jax.tree.map(lambda o: o[None], fn(*[x[0] for x in xs]))
    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data"), check_vma=False))
    return jax.tree.map(np.asarray, f(*arrays))


def psgd_sync(n):
    """The JAX PowerSGD session's initial sync state (its basis)."""
    params, _, _ = worker.lin_problem()
    sess = jax_session(n, JAllReduce(compressor="PowerSGDCompressor"),
                       params, jax_lin_loss, optax.sgd(0.1))
    return jax.tree.map(np.asarray, sess.sync_state)


@pytest.fixture(scope="module")
def p6(tmp_path_factory):
    return spawn_p6(2, tmp_path_factory.mktemp("p6"), psgd_sync(2))


def _bf16_atol(x, n):
    """The largest gap two orders of an ``n``-term bf16 sum of values
    of ``x``'s size can leave: one bf16 rounding per addition, a half ulp
    (2^-9 relative) of the partial sum each."""
    return (n - 1) * 2.0 ** -9 * n * float(np.abs(x).max())


def check_units(inputs, outs, n):
    """Each compressor's reduce / reduce_scatter against the JAX
    compressor's under ``shard_map`` on the same rows."""
    g, s, v = inputs["g"], inputs["s"], inputs["v"]
    for name in ("HorovodCompressor", "HorovodCompressorEF"):
        comp = jget_compressor(name)
        ef = name.endswith("EF")
        red, st = jax_unit(n, lambda g_, s_: comp.reduce(
            g_, s_ if ef else None, "data"), g, s)
        shard, rst = jax_unit(n, lambda v_: comp.reduce_scatter(
            v_, v_ * 1e-3 if ef else None, "data"), v)
        for r, out in enumerate(outs):
            np.testing.assert_allclose(out[f"unit/{name}/reduce"], red[r],
                                       rtol=0, atol=_bf16_atol(g, n))
            np.testing.assert_allclose(out[f"unit/{name}/rs"], shard[r],
                                       rtol=0, atol=_bf16_atol(v, n))
            if ef:      # the residual is local: the same bits
                np.testing.assert_array_equal(out[f"unit/{name}/state"],
                                              st[r])
                np.testing.assert_array_equal(
                    out[f"unit/{name}/rs_state"], rst[r])
    comp = jget_compressor("PowerSGDCompressor")
    q = jnp.asarray(inputs["q"])
    red, new = jax_unit(n, lambda g_, s_: comp.reduce(
        g_, {"q": q, "residual": s_}, "data"), g, s)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["unit/PowerSGD/reduce"], red[r],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["unit/PowerSGD/residual"],
                                   new["residual"][r], rtol=1e-5, atol=1e-6)
        # QR's column signs are the factorization's choice: compare Q up
        # to the sign of each column
        got, want = out["unit/PowerSGD/q"], new["q"][r]
        sign = np.sign((got * want).sum(0))
        np.testing.assert_allclose(got * sign, want, rtol=1e-5, atol=1e-6)


def test_compressor_units_match_jax(p6):
    inputs, outs = p6
    check_units(inputs, outs, 2)


def check_compressor_sessions(outs, n, names=worker.P6_COMPRESSORS):
    """5 SGD steps under each compressor against the JAX session at the
    same data size (PowerSGD from the JAX basis)."""
    params, _, batch = worker.lin_problem()
    for name in names:
        jsess = jax_session(n, JAllReduce(compressor=name), params,
                            jax_lin_loss, optax.sgd(0.1))
        want = [float(jsess.run(batch)["loss"]) for _ in range(5)]
        jp = jax.tree.map(np.asarray, jsess.params)
        for out in outs:
            np.testing.assert_allclose(out[f"comp/{name}/5"], want,
                                       rtol=1e-5, err_msg=name)
            for k, x in flatten(jp):
                np.testing.assert_allclose(out[f"comp/{name}/p/{k}"], x,
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} {k}")


def test_compressor_sessions_match_jax(p6):
    check_compressor_sessions(p6[1], 2)


def test_compressors_converge_and_error_feedback_is_not_worse(p6):
    """``tests/test_compressors.py:102-124``'s properties, on 2 ranks."""
    for out in p6[1]:
        for name in ("HorovodCompressor", "HorovodCompressorEF"):
            losses = out[f"comp/{name}/60"]
            assert losses[-1] < losses[0] * 0.05, (name, losses)
        plain = out["comp/HorovodCompressor/60"][:30]
        ef = out["comp/HorovodCompressorEF/60"][:30]
        assert ef[-1] <= plain[-1] * 1.5
        psgd = out["comp/PowerSGDCompressor/60"]
        assert psgd[-1] < psgd[0] * 0.2, psgd


def check_program_e(outs, n, comp_rtol=1e-5):
    """Program E: bf16+EF, fused groups, ``accum_steps=2`` at rtol 5e-3
    of the uncompressed run, and its losses against the JAX program's at
    ``comp_rtol``; fused groups' buckets and losses against the JAX
    session's at 1e-5."""
    params, _, batch = worker.prog_e_problem(n)
    jp = jax.tree.map(jnp.asarray, params)
    runs = {"e_comp": (JAllReduce(compressor="HorovodCompressorEF",
                                  fused_groups=True, chunk_size=2), 2),
            "fused": (JAllReduce(chunk_size=2, fused_groups=True), 1)}
    for tag, (builder, accum) in runs.items():
        jsess = jax_session(n, builder, jp, jax_prog_e_loss, optax.sgd(0.1),
                            accum=accum)
        want = [float(jsess.run(batch)["loss"]) for _ in range(5)]
        keys = sorted(b.key for b in jes.plan_step_buckets(
            JGraphItem(jp), jsess._step.compiled_strategy, {}, n))
        for out in outs:
            np.testing.assert_allclose(
                out[f"{tag}/losses"], want, err_msg=tag,
                rtol=comp_rtol if tag == "e_comp" else 1e-5)
            assert list(out[f"{tag}/buckets"]) == keys, tag
    for out in outs:
        np.testing.assert_allclose(out["e_comp/losses"], out["e_ref/losses"],
                                   rtol=5e-3)
        np.testing.assert_allclose(out["fused/losses"], out["plain/losses"],
                                   rtol=1e-5)
        assert len(out["e_comp/sync"]) == len(out["e_comp/buckets"]) == 2


def test_program_e_and_fused_groups_match_jax(p6):
    check_program_e(p6[1], 2)


def simulate_delayed(staleness, steps, refresh=1):
    """``tests/test_stale_sync.py``'s oracle: SGD(0.1) where the gradient
    of step t (against a mirror refreshed every ``refresh`` steps) applies
    at step t + s."""
    params, _, batches = worker.stale_problem(steps)
    w = np.array(params["w"])
    cache = w.copy()
    queue = [np.zeros_like(w) for _ in range(staleness)]
    gradf = jax.grad(jax_stale_loss)
    for t, b in enumerate(batches):
        read = cache if refresh > 1 else w
        g = np.asarray(gradf({"w": read}, b)["w"])
        if staleness:
            queue.append(g)
            g = queue.pop(0)
        w = w - 0.1 * g
        if refresh > 1 and (t + 1) % refresh == 0:
            cache = w.copy()
    return w


def check_stale(outs):
    for tag, kw, refresh, steps in worker.STALE_RUNS:
        want = simulate_delayed(kw.get("staleness", 0), steps,
                                refresh if kw.get("local_proxy_variable")
                                else 1)
        for out in outs:
            np.testing.assert_allclose(out[f"stale/{tag}/w"], want,
                                       rtol=1e-5, atol=1e-6, err_msg=tag)
    for out in outs:
        np.testing.assert_array_equal(out["stale/warm3/w"], 0.0)


def test_staleness_and_proxies_match_the_delayed_gradient_oracle(p6):
    check_stale(p6[1])


def test_jax_stale_session_matches_the_same_oracle():
    """The oracle is the JAX package's: its PS(staleness=2) session with
    proxies refreshed every 2 steps on 2 devices lands on it too."""
    os.environ["AUTODIST_PROXY_REFRESH"] = "2"
    try:
        params, _, batches = worker.stale_problem(10)
        jsess = jax_session(2, JPS(staleness=2, local_proxy_variable=True),
                            jax.tree.map(jnp.asarray, params),
                            jax_stale_loss, optax.sgd(0.1))
        for b in batches:
            jsess.run(b)
    finally:
        os.environ.pop("AUTODIST_PROXY_REFRESH")
    np.testing.assert_allclose(np.asarray(jsess.params["w"]),
                               simulate_delayed(2, 10, 2), rtol=1e-5,
                               atol=1e-6)


def _lm_params():
    return params_to_numpy(transformer_lm(**worker.CFG).init(0,
                                                             device="cpu"))


def _jax_lm_session(n, builder, params, accum, cfg=None, opt=None,
                    numerics=None):
    jspec = jax_lm(**(cfg or worker.CFG), attn_fn=jax_dense)
    return jax_session(n, builder, params, jspec.loss_fn,
                       opt or optax.adam(1e-2), accum=accum,
                       sparse_vars=jspec.sparse_vars, numerics=numerics)


def _assert_lm_params(out, prefix, jsess, atol=1e-4):
    for k, x in flatten(jax.tree.map(np.asarray, jsess.params)):
        np.testing.assert_allclose(out[f"{prefix}/p/{k}"], x, rtol=0,
                                   atol=atol, err_msg=f"{prefix} {k}")


#: the pipeline runs held against JAX: (tag, the JAX builder, rows a rank)
PIPE_VS_JAX = [
    ("zero1_pipe", lambda: JZero1(overlap="pipeline"), 4),
    ("ar_pipe", lambda: JAllReduce(bucket_bytes=1 << 20,
                                   overlap="pipeline"), 4),
    ("zero1_pipe_uneven", lambda: JZero1(overlap="none"), 5)]


def check_pipeline(outs, n, tag, jbuilder, rows):
    """Even microbatches against the JAX pipeline; the uneven tail against
    the JAX package's unpipelined accumulation."""
    spec = transformer_lm(**worker.CFG)
    batch = spec.sample_batch(rows * n, seed=1)
    jsess = _jax_lm_session(n, jbuilder(), _lm_params(), 2)
    want = [float(jsess.run(batch)["loss"]) for _ in range(3)]
    for out in outs:
        np.testing.assert_allclose(out[f"pipe/{tag}/losses"], want,
                                   rtol=1e-5)
        _assert_lm_params(out, f"pipe/{tag}", jsess)


@pytest.mark.parametrize("tag,jbuilder,rows", PIPE_VS_JAX)
def test_pipelined_accumulation_matches_jax(p6, tag, jbuilder, rows):
    check_pipeline(p6[1], 2, tag, jbuilder, rows)


def check_pipeline_vs_sequential(outs):
    """The pipeline against the port's ``overlap="none"``: a linear f32
    bucket's microbatch means sum to the sequential mean up to the order
    of the sums."""
    for out in outs:
        for pipe, none in (("zero1_pipe", "zero1_none"),
                           ("zero1_pipe_uneven", "zero1_none_uneven")):
            np.testing.assert_allclose(out[f"pipe/{pipe}/losses"],
                                       out[f"pipe/{none}/losses"],
                                       rtol=1e-6)
            for k in out:
                if k.startswith(f"pipe/{pipe}/p/"):
                    np.testing.assert_allclose(
                        out[k], out[k.replace(pipe, none, 1)], rtol=0,
                        atol=1e-5, err_msg=k)


def test_pipeline_equals_the_sequential_schedule(p6):
    check_pipeline_vs_sequential(p6[1])


def check_quantized_pipeline(outs, n, tag, overlap):
    """``Int8Compressor`` buckets under an explicit ``pipeline`` / ``full``
    at ``accum_steps=2``: one quantized collective per microbatch slot
    (the ring at 256 KiB under ``full``), against the JAX session's
    losses and lowerings."""
    params = params_to_numpy(transformer_lm(**worker.QUANT_CFG).init(
        0, device="cpu"))
    batch = transformer_lm(**worker.QUANT_CFG).sample_batch(8, seed=1)
    jsess = _jax_lm_session(
        n, JZero1(worker.QUANT_BUCKET_BYTES, compressor="Int8Compressor",
                  overlap=overlap), params, 2, cfg=worker.QUANT_CFG,
        opt=jax_fusable_adam(worker.QUANT_LR),
        numerics={"clip_norm": worker.CLIP})
    want = [float(jsess.run(batch)["loss"]) for _ in range(3)]
    algs = sorted(f"{b['key']}={b['alg']}"
                  for b in jsess.schedule_ir.buckets)
    for out in outs:
        assert list(out[f"qpipe/{tag}/algs"]) == algs
        np.testing.assert_allclose(out[f"qpipe/{tag}/losses"], want,
                                   rtol=1e-5)


@pytest.mark.parametrize("tag,overlap", [("int8_pipeline", "pipeline"),
                                         ("int8_full", "full")])
def test_quantized_pipeline_matches_jax(p6, tag, overlap):
    check_quantized_pipeline(p6[1], 2, tag, overlap)
