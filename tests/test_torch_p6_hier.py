"""The P6 options on 4 gloo ranks (``tests/torch_dp_worker.py`` mode
``p6``, one launch): the two-tier ``hier`` sync against the flat one and
the JAX package's on a 4-device mesh in 2 slices
(``tests/test_hier_sync.py:108-141``), a ``hier`` checkpoint restored
into a flat session and the other way round, and the compressors,
Program E, the pipeline and bounded staleness of
``tests/test_torch_p6_dp.py`` at 4 ranks.

Tolerances: ``hier`` against flat at 1e-6 in f32 and 2e-2 with the int8
cross-slice wire (the JAX test's); at 4 ranks a bf16 sum may add in
another order on each side, so the compressor units hold to
``test_torch_p6_dp._bf16_atol`` and their sessions to rtol 1e-3 (a few
bf16 roundings of the gradient, through 5 SGD steps).
"""
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest

from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import Zero1 as JZero1
from autodist_tpu_torch.graph_item import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_p6_dp as p6dp  # noqa: E402
import torch_dp_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

N = 4
JAX_HIER_SPEC = {"nodes": [{"address": "localhost", "chips": N,
                            "chief": True}], "num_slices": 2}


@pytest.fixture(scope="module")
def p6(tmp_path_factory):
    return p6dp.spawn_p6(N, tmp_path_factory.mktemp("p6h"), p6dp.psgd_sync(N))


@pytest.mark.parametrize("wire,tol", [("f32", 1e-6), ("int8", 2e-2)])
@pytest.mark.parametrize("kind", ["ar", "zero1"])
def test_hier_matches_flat(p6, wire, tol, kind):
    """The two-tier lowering against the flat one: losses and parameters
    at the JAX test's tolerance, one bucket two-tier."""
    for out in p6[1]:
        base = f"hier/{wire}/{kind}"
        assert int(out[f"{base}/hier/hier_keys"]) == 1
        assert int(out[f"{base}/flat/hier_keys"]) == 0
        np.testing.assert_allclose(out[f"{base}/hier/losses"],
                                   out[f"{base}/flat/losses"], rtol=tol,
                                   atol=tol)
        for k in out:
            if k.startswith(f"{base}/hier/p/"):
                np.testing.assert_allclose(
                    out[k], out[k.replace("/hier/p/", "/flat/p/")],
                    rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("kind,jbuilder", [
    ("ar", lambda: JAllReduce(bucket_bytes=1 << 20, hier=True)),
    ("zero1", lambda: JZero1(hier=True))])
def test_hier_matches_jax(p6, kind, jbuilder):
    """The port's two-tier step against the JAX package's on 4 devices in
    2 slices, f32: losses at rtol 1e-5, parameters at 1e-5; the 4 ranks'
    parameters bit-identical."""
    params, _, batch = worker.hier_problem()

    def jloss(p, b):
        h = jax.numpy.tanh(b["x"] @ p["a"]["w"] + p["a"]["b"])
        return jax.numpy.mean((h @ p["out"]["w"] - b["y"]) ** 2)
    jsess = p6dp.jax_session(N, jbuilder(), params, jloss, optax.adam(1e-2),
                             info=JAX_HIER_SPEC)
    assert any(b.get("hier") for b in jsess.schedule_ir.buckets)
    want = [float(jsess.run(batch)["loss"]) for _ in range(5)]
    outs = p6[1]
    for out in outs:
        key = f"hier/f32/{kind}/hier"
        np.testing.assert_allclose(out[f"{key}/losses"], want, rtol=1e-5)
        for k, x in flatten(jax.tree.map(np.asarray, jsess.params)):
            np.testing.assert_allclose(out[f"{key}/p/{k}"], x, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(out[f"{key}/p/{k}"],
                                          outs[0][f"{key}/p/{k}"])


@pytest.mark.parametrize("direction", ["1to0", "0to1"])
def test_hier_checkpoint_restores_flat_and_back(p6, direction):
    """A ZeRO-1 checkpoint taken under ``hier`` (rank ``g·d_in + i`` holds
    chunk ``i·s + g``) restores into a flat session by its logical
    tensors, and a flat one into a ``hier`` session: the restored
    session's logical state equals the writer's, and the next step's loss
    is the writer's to the bit."""
    for out in p6[1]:
        assert bool(out[f"hier_ckpt/{direction}/same"])
        nxt = out[f"hier_ckpt/{direction}/next"]
        assert nxt[0] == nxt[1]


def test_compressor_units_match_jax(p6):
    p6dp.check_units(*p6, N)


def test_compressor_sessions_match_jax(p6):
    """bf16 sums of 4 terms may round in another order on each side:
    rtol 1e-3 for the cast compressors; the others at 1e-5."""
    outs = p6[1]
    p6dp.check_compressor_sessions(
        outs, N, names=("NoneCompressor", "PowerSGDCompressor"))
    params, _, batch = worker.lin_problem()
    for name in ("HorovodCompressor", "HorovodCompressorEF"):
        jsess = p6dp.jax_session(N, JAllReduce(compressor=name), params,
                                 p6dp.jax_lin_loss, optax.sgd(0.1))
        want = [float(jsess.run(batch)["loss"]) for _ in range(5)]
        for out in outs:
            np.testing.assert_allclose(out[f"comp/{name}/5"], want,
                                       rtol=1e-3, err_msg=name)


def test_staleness_and_proxies_match_the_oracle(p6):
    p6dp.check_stale(p6[1])


def test_program_e_holds_at_four_ranks(p6):
    for out in p6[1]:
        np.testing.assert_allclose(out["e_comp/losses"], out["e_ref/losses"],
                                   rtol=5e-3)
        np.testing.assert_allclose(out["fused/losses"], out["plain/losses"],
                                   rtol=1e-5)


@pytest.mark.parametrize("tag,jbuilder,rows", p6dp.PIPE_VS_JAX)
def test_pipelined_accumulation_matches_jax(p6, tag, jbuilder, rows):
    p6dp.check_pipeline(p6[1], N, tag, jbuilder, rows)


def test_pipeline_equals_the_sequential_schedule(p6):
    p6dp.check_pipeline_vs_sequential(p6[1])


@pytest.mark.parametrize("tag,overlap", [("int8_pipeline", "pipeline"),
                                         ("int8_full", "full")])
def test_quantized_pipeline_matches_jax(p6, tag, overlap):
    p6dp.check_quantized_pipeline(p6[1], N, tag, overlap)


def test_program_e_and_fused_groups_match_jax(p6):
    """The bf16 wire at the 4-rank sum-order tolerance (rtol 1e-3)."""
    p6dp.check_program_e(p6[1], N, comp_rtol=1e-3)
