"""The port's quantized ring (``quant_ring``, ``overlap``, ``compressor``,
K6–K8's plain versions) against the JAX package.

Inputs come from numpy with a seed and go to both sides.  Tolerances, as
the JAX package's own tests hold them (``tests/test_fused_kernels.py:
148-199``, ``tests/test_quant_ring.py``):

* the wire payload bit-equal (fp8 NaN as NaN), the scales at rtol 1e-6
  (they come out equal: the port divides by ``qmax`` as XLA compiles it),
  the error at atol 1e-6, the saturation count exact for int8 and within
  one for fp8 (the amax element sits on the rail);
* the ring functions on 4 gloo ranks against the JAX functions under
  ``shard_map`` on 4 CPU devices at 1e-6, and the grid-exact fixture
  equal to the true mean at 1e-6;
* sessions on 8 gloo ranks against the JAX facade's 8-device mesh: losses
  at rtol 1e-5, saturation counts equal, parameters and error-feedback
  residuals at atol 1e-5.  Fed the same gradients (a loss linear in the
  parameters) that holds for every element.  On the model's own loss the
  two frameworks' gradients differ in their last bits, and an element on
  a rounding tie of the wire grid quantizes one quantum apart: there, one
  step from the JAX session's state, at most 1% of each leaf's elements
  (one, in a leaf of fewer than 100) may pass 1e-5, each within one
  quantum (a residual) or one Adam step of the learning rate (a
  parameter).
"""
import itertools
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
from autodist_tpu.kernel.synchronization import bucketing as jbucketing
from autodist_tpu.kernel.synchronization import overlap as jov
from autodist_tpu.kernel.synchronization import quant_ring as jqr
from autodist_tpu.kernel.synchronization import schedule_ir as jsir
from autodist_tpu.kernel.synchronization.compressor import \
    get_compressor as jget_compressor
from autodist_tpu.models.transformer import dense_attention as jax_dense
from autodist_tpu.models.transformer_lm import transformer_lm as jax_lm
from autodist_tpu.ops import fused_kernels as jfk
from autodist_tpu.ops import quant_scale as jqs
from autodist_tpu.ops.fused_kernels import fusable_adam as jax_fusable_adam
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import Zero1 as JZero1
from autodist_tpu.utils import compat
from autodist_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                        params_to_numpy, sync_state_from_jax)
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.kernel.synchronization import bucketing
from autodist_tpu_torch.kernel.synchronization import overlap as ov
from autodist_tpu_torch.kernel.synchronization import quant_ring as qr
from autodist_tpu_torch.kernel.synchronization import schedule_ir as psir
from autodist_tpu_torch.kernel.synchronization.compressor import \
    get_compressor
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.ops import fused_kernels as fk
from autodist_tpu_torch.ops import quant_scale

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dp_worker  # noqa: E402
import torch_launch  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
FORMATS = {"int8": (qr.WIRE_INT8, jqr.WIRE_INT8),
           "fp8": (qr.WIRE_FP8_E4M3, jqr.WIRE_FP8_E4M3)}
LENGTHS = (3000, 2048, 1_000_003)


def _bits(t) -> np.ndarray:
    """A wire payload (torch or JAX) as its bytes."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy() if t.dtype != torch.int8 \
            else t.numpy().view(np.uint8)
    return np.asarray(t).view(np.uint8)


def _assert_payload_equal(got, want, fmt_name):
    got, want = _bits(got), _bits(want)
    if fmt_name == "fp8":       # e4m3fn NaN is S.1111.111: compare as NaN
        nan_g, nan_w = (got & 0x7F) == 0x7F, (want & 0x7F) == 0x7F
        np.testing.assert_array_equal(nan_g, nan_w)
        got, want = got[~nan_g], want[~nan_w]
    np.testing.assert_array_equal(got, want)


def _input(n, seed, poisoned=False, scale=3.0):
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)
    if poisoned:
        x[[5, n // 2, n - 1]] = (np.inf, np.nan, -np.inf)
    return x


# -- the scale rule and the plain quantizer ---------------------------------
@pytest.mark.parametrize("qmax", [127.0, 448.0])
def test_quant_scale_helpers_match_jax(qmax):
    rng = np.random.default_rng(int(qmax))
    amax = np.abs(rng.standard_normal(4096).astype(np.float32)) * 10
    amax[:3] = (0.0, 1e-35, 3.0e38)
    got = quant_scale.chunk_scale(torch.from_numpy(amax), qmax)
    want = jax.jit(lambda a: jqs.chunk_scale(a, qmax))(jnp.asarray(amax))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = (rng.standard_normal(4096) * qmax).astype(np.float32)
    y[:4] = (np.nan, np.inf, -np.inf, 0.5)
    finite = np.isfinite(y)
    for rounded in (True, False):
        got_n = quant_scale.saturation_count(
            torch.from_numpy(y), torch.from_numpy(finite), qmax,
            rounded=rounded)
        want_n = jqs.saturation_count(jnp.asarray(y), jnp.asarray(finite),
                                      qmax, rounded=rounded)
        assert int(got_n) == int(want_n)
    wire = (torch.int8, jnp.int8) if qmax == 127.0 else \
        (torch.float8_e4m3fn, jnp.float8_e4m3fn)
    rounded = qmax == 127.0
    got_q = quant_scale.quantize_values(torch.from_numpy(y), qmax, wire[0],
                                        rounded=rounded)
    want_q = jax.jit(lambda v: jqs.quantize_values(
        v, qmax, wire[1], rounded=rounded))(jnp.asarray(y))
    _assert_payload_equal(got_q, want_q, "int8" if rounded else "fp8")


@pytest.mark.parametrize("fmt_name", list(FORMATS))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("poisoned", [False, True])
def test_quantize_blocks_matches_jax(fmt_name, n, poisoned):
    """``quantize_blocks``/``dequantize_blocks`` against the JAX functions
    as a step compiles them: payload, scales and count exactly."""
    fmt, jfmt = FORMATS[fmt_name]
    x = _input(n, n, poisoned)
    q, s, sat = qr.quantize_blocks(torch.from_numpy(x), fmt)
    jq, js, jsat = jax.jit(lambda v: jqr.quantize_blocks(v, jfmt))(
        jnp.asarray(x))
    assert q.dtype == qr.wire_dtype(fmt) and q.shape == (n,)
    assert s.shape == (qr.scale_count(n),) and sat.dtype == torch.float32
    _assert_payload_equal(q, jq, fmt_name)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(sat) == float(jsat) == (3.0 if poisoned else 0.0)
    deq = qr.dequantize_blocks(q, s)
    jdeq = jax.jit(jqr.dequantize_blocks)(jq, js)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))


def test_scale_byte_accounting_matches_jax():
    for n in (0, 1, 255, 256, 257, 6_168_576, 1_000_003):
        assert qr.scale_count(n) == jqr.scale_count(n)
        assert qr.scale_nbytes(n) == jqr.scale_nbytes(n)
        for fmt, jfmt in FORMATS.values():
            assert qr.wire_nbytes(n, fmt) == jqr.wire_nbytes(n, jfmt)
    for comp in ("Int8Compressor", "Fp8Compressor", "NoneCompressor", ""):
        assert qr.is_quant_ring_compressor(comp) == \
            jqr.is_quant_ring_compressor(comp)
        assert (qr.wire_format_of(comp) is None) == \
            (jqr.wire_format_of(comp) is None)


# -- the plain versions of K6-K8 against the JAX kernels (interpret mode) ----
@pytest.mark.parametrize("fmt_name", list(FORMATS))
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("poisoned", [False, True])
def test_plain_hop_kernels_match_jax_fused(fmt_name, n, poisoned):
    fmt, jfmt = FORMATS[fmt_name]
    x, chunk = _input(n, n, poisoned), _input(n, n + 1, scale=1.0)
    slack = 0 if fmt_name == "int8" else 1

    def check(got, want):
        (q, s, err, sat), (jq, js, jerr, jsat) = got, want
        _assert_payload_equal(q, jq, fmt_name)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6,
                                   rtol=0)
        assert abs(float(sat) - float(jsat)) <= slack

    got = fk.fused_quantize(torch.from_numpy(x), fmt)
    want = jfk.fused_quantize(jnp.asarray(x), jfmt, interpret=True)
    check(got, want)
    if poisoned:
        assert float(got[3]) >= 3
    # the hop's inputs at the scale of the JAX kernel test's
    # (``tests/test_fused_kernels.py:180-199``)
    q_in, s_in, _, _ = fk.fused_quantize(torch.from_numpy(x) / 3, fmt)
    jq_in, js_in, _, _ = jfk.fused_quantize(jnp.asarray(x) / 3, jfmt,
                                            interpret=True)
    c = torch.from_numpy(chunk)
    check(fk.fused_hop_accumulate(q_in, s_in, c, fmt),
          jfk.fused_hop_accumulate(jq_in, js_in, jnp.asarray(chunk), jfmt,
                                   interpret=True))
    np.testing.assert_allclose(
        fk.fused_dequant_add(q_in, s_in, c, fmt).numpy(),
        np.asarray(jfk.fused_dequant_add(jq_in, js_in, jnp.asarray(chunk),
                                         jfmt, interpret=True)),
        atol=1e-6, rtol=0)
    assert fk.fused_quantize.calls == fk.fused_hop_accumulate.calls == \
        fk.fused_dequant_add.calls == 0     # CPU: the plain versions


def test_hop_kernels_check_their_inputs():
    fmt = qr.WIRE_INT8
    x = torch.zeros(300)
    q, s, _, _ = fk.fused_quantize(x, fmt)
    with pytest.raises(TypeError):
        fk.fused_quantize(x.double(), fmt)
    with pytest.raises(ValueError, match="q_in"):
        fk.fused_hop_accumulate(q.view(torch.uint8), s, x, fmt)
    with pytest.raises(ValueError, match="scales_in"):
        fk.fused_dequant_add(q, s[:1], x, fmt)
    active, _ = fk.resolve_fused(guard=True, has_rs=False,
                                 has_quant_ring=True)
    assert active == (fk.KERNEL_GUARD, fk.KERNEL_QUANT_HOP)


# -- the pure rules ------------------------------------------------------------
def _plan_cases():
    """Buckets of every kind: small (3 KB), at the threshold, large; int8,
    fp8 and uncompressed; all-reduce and ZeRO-1 — one bucket each."""
    entries = []
    for i, (elems, comp, mode) in enumerate(itertools.product(
            (768, 65_536, 262_144),
            ("NoneCompressor", "Int8Compressor", "Fp8Compressor"),
            ("all_reduce", "reduce_scatter"))):
        entries.append((f"v{i}", (elems,), "float32", comp, i, mode))
    return entries


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["auto", "none", "ring", "full"])
def test_schedule_rules_match_jax_ir(d, mode):
    """``resolve_overlap``, the port's schedule IR's ``reduce_alg`` (the
    lowering the step reads) and ``gather_schedule`` equal the JAX
    package's ``resolve_overlap`` and its schedule IR's ``reduce_alg`` /
    ``gather_plan`` order."""
    entries = _plan_cases()
    buckets = bucketing.assign_buckets(entries, 1 << 30, d)
    jbuckets = jbucketing.assign_buckets(entries, 1 << 30, d)
    has_rs = any(b.mode == "reduce_scatter" for b in buckets)
    plan = ov.resolve_overlap([mode], accum_steps=1, buckets=buckets, d=d,
                              has_rs=has_rs)
    jplan = jov.resolve_overlap([mode], accum_steps=1, buckets=jbuckets,
                                d=d, has_rs=has_rs)
    assert (plan.mode, plan.pipeline, plan.ring, plan.one_shot_small,
            plan.prefetch, plan.ring_threshold, plan.drops) == (
        jplan.mode, jplan.pipeline, jplan.ring, jplan.one_shot_small,
        jplan.prefetch, jplan.ring_threshold, jplan.drops)
    ir = jsir.build_schedule_ir(axes={"data": d}, accum_steps=1,
                                buckets=jbuckets, plan=jplan)
    port_ir = psir.build_schedule_ir(axes={"data": d}, accum_steps=1,
                                     buckets=buckets, plan=plan)
    assert {b.key: port_ir.reduce_alg(b.key) for b in buckets} == \
        {b.key: ir.reduce_alg(b.key) for b in jbuckets}
    rs = [b for b in buckets if b.mode == "reduce_scatter"]
    assert [b.key for b in ov.gather_schedule(rs, plan.prefetch)] == \
        [key for key, _ in ir.gather_plan()]
    algs = {port_ir.reduce_alg(b.key) for b in buckets}
    assert algs == ({"fused"} if d == 1 or mode == "none" else
                    {"ring", "fused"} if mode == "auto" else
                    {"ring", "one_shot", "fused"})


@pytest.mark.parametrize("mode,accum,comp", [
    ("pipeline", 1, "NoneCompressor"), ("auto", 2, "Int8Compressor"),
    ("auto", 2, "NoneCompressor"), ("full", 2, "HorovodCompressor"),
    ("sometimes", 1, "NoneCompressor")])
def test_overlap_drop_reason_matches_jax(mode, accum, comp):
    for bucketable, explicit in itertools.product((True, False), repeat=2):
        assert ov.overlap_drop_reason(
            mode, accum_steps=accum, compressor=comp, bucketable=bucketable,
            explicit_path=explicit) == jov.overlap_drop_reason(
            mode, accum_steps=accum, compressor=comp, bucketable=bucketable,
            explicit_path=explicit)


def test_quant_ring_degenerate_single_rank():
    x = torch.arange(8.0)
    out, err, sat = qr.quantized_ring_reduce_scatter(x, None, 1,
                                                     qr.WIRE_INT8)
    assert out is x and float(sat) == 0.0 and not err.any()
    out2, _ = qr.quantized_ring_all_gather(x, None, 1, qr.WIRE_INT8)
    assert out2 is x
    red, state, _ = qr.quant_bucket_reduce(x, torch.ones(8), None, 1,
                                           qr.WIRE_INT8, mode="all_reduce",
                                           alg="ring")
    assert torch.equal(red, x + 1) and not state.any()


@pytest.mark.parametrize("name,item", [
    ("HorovodCompressor", "P6 — cast and low-rank"),
    ("HorovodCompressorEF", "P6 — cast and low-rank"),
    ("PowerSGDCompressor", "P6 — cast and low-rank")])
def test_unported_compressors_raise(name, item):
    """Once refused naming ``item``, the cast and low-rank compressors are
    registered: JAX's name and ``bucketable`` flag, state of the JAX
    compressor's structure, shapes and dtypes (zeros where it is zeros),
    and at one rank the identity, as the JAX package's GSPMD step at data
    size 1 is."""
    comp, jcomp = get_compressor(name), jget_compressor(name)
    assert (comp.name, comp.bucketable) == (jcomp.name, jcomp.bucketable)
    for shape in ((6, 5), (7,)):
        x = torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)
        st = comp.init_state(x)
        jst = jcomp.init_state(jnp.asarray(x.numpy()))
        got = [] if st is None else sorted(flatten(st)) if isinstance(
            st, dict) else [("", st)]
        want = [] if jst is None else sorted(
            (k, np.asarray(v)) for k, v in jst.items()) if isinstance(
            jst, dict) else [("", np.asarray(jst))]
        assert [(k, tuple(v.shape)) for k, v in got] == \
            [(k, v.shape) for k, v in want]
        for (k, v), (_, w) in zip(got, want):
            assert str(v.dtype).endswith(w.dtype.name)
            if k != "q":       # PowerSGD's basis: another generator
                np.testing.assert_array_equal(v.numpy(), w)
        out, st2 = comp.reduce(x, st, None, 1)
        assert out is x and st2 is st
    with pytest.raises(ValueError, match="unknown compressor"):
        get_compressor("ZipCompressor")
    assert get_compressor("").name == jget_compressor(
        "NoneCompressor").name


# -- the ring functions on 4 gloo ranks ----------------------------------------
def _spawn(world, tmp_path, mode, infile, timeout=240):
    torch_launch.run(
        lambda rank, init: [WORKER, rank, world, init,
                            tmp_path / f"rank{rank}.npz", mode, infile],
        world=world, tmp_dir=tmp_path, timeout=timeout)
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def _grid_exact(n, length, fmt_name, seed=0):
    """``x_d = c_d · v`` (``tests/test_quant_ring.py:61-78``): every
    quantize event of any partial sum is exact on its grid."""
    rng = np.random.RandomState(seed)
    block = min(qr.QUANT_BLOCK_ELEMS, length // n)
    if fmt_name == "int8":
        v = rng.randint(-126, 127, length).astype(np.float32)
        v[::block] = 127.0
    else:
        v = (2.0 ** rng.randint(-3, 4, length)).astype(np.float32) \
            * rng.choice([-1.0, 1.0], length)
    c = (2.0 ** rng.randint(-2, 3, n)).astype(np.float32)
    return c[:, None] * v[None, :]


def _jax_ring_functions(x, grid_int8, grid_fp8, state, n):
    """The JAX twin of ``torch_dp_worker.ring_functions`` under shard_map
    on ``n`` CPU devices: ``{name: [n, ...]}``."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))

    def body(xs, gi8, gf8, st):
        xs, st = xs.reshape(-1), st.reshape(-1)
        out = {}
        for jfmt, f in ((jqr.WIRE_INT8, "int8"), (jqr.WIRE_FP8_E4M3, "fp8")):
            fname = jfmt.name
            for fused in (False, True):
                red, err, sat = jqr.quantized_ring_reduce_scatter(
                    xs, "data", n, jfmt, fused=fused)
                out.update({f"rs_{fname}_{fused}": red,
                            f"rs_err_{fname}_{fused}": err,
                            f"rs_sat_{fname}_{fused}": sat})
            out[f"ag_{fname}"], out[f"ag_sat_{fname}"] = \
                jqr.quantized_ring_all_gather(red / n, "data", n, jfmt)
            (out[f"a2a_{fname}"], out[f"a2a_err_{fname}"],
             out[f"a2a_sat_{fname}"]) = \
                jqr.quantized_all_to_all_reduce_scatter(xs, "data", n, jfmt)
            out[f"qag_{fname}"], out[f"qag_sat_{fname}"] = \
                jqr.quantized_all_gather(out[f"a2a_{fname}"] / n, "data", n,
                                         jfmt)
            grid = (gi8 if f == "int8" else gf8).reshape(-1)
            for mode in ("all_reduce", "reduce_scatter"):
                for alg in ("ring", "fused"):
                    for fused in ((False, True) if alg == "ring"
                                  else (False,)):
                        tag = f"{fname}_{mode}_{alg}_{fused}"
                        (out[f"qbr_{tag}"], out[f"qbr_state_{tag}"],
                         out[f"qbr_sat_{tag}"]) = jqr.quant_bucket_reduce(
                            xs, st, "data", n, jfmt, mode=mode, alg=alg,
                            fused=fused)
                        out[f"grid_{tag}"], _, out[f"grid_sat_{tag}"] = \
                            jqr.quant_bucket_reduce(
                                grid, jnp.zeros_like(grid), "data", n, jfmt,
                                mode=mode, alg=alg, fused=fused)
        comp = jget_compressor("Int8Compressor")
        (out["c_red_Int8Compressor"],
         out["c_red_state_Int8Compressor"]) = comp.reduce(
            xs.reshape(n, -1), st.reshape(n, -1) * 0, "data")
        (out["c_rs_Int8Compressor"],
         out["c_rs_state_Int8Compressor"]) = comp.reduce_scatter(
            xs, st * 0, "data")
        none = jget_compressor("NoneCompressor")
        out["c_red_NoneCompressor"], _ = none.reduce(xs.reshape(n, -1), None,
                                                     "data")
        out["c_rs_NoneCompressor"], _ = none.reduce_scatter(xs, None, "data")
        return {k: (v.view(jnp.uint8) if v.dtype.itemsize == 1
                    and v.dtype != jnp.int8 else v).reshape(1, -1)
                for k, v in out.items()}

    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=P("data"),
                                  out_specs=P("data"), check_vma=False))
    out = fn(*(jnp.asarray(a) for a in (x, grid_int8, grid_fp8, state)))
    return {k: np.asarray(v) for k, v in out.items()}


def test_ring_functions_on_four_gloo_ranks_match_jax(tmp_path):
    """Every ring function on 4 gloo CPU ranks against the JAX function
    under shard_map on 4 CPU devices (1e-6; payload-derived outputs and
    counts exactly), fused against unfused, and the grid-exact fixture
    equal to the true mean."""
    n, length = 4, 4 * 1000          # chunks of 1000: a ragged last block
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((n, length)) * 2).astype(np.float32)
    state = (rng.standard_normal((n, length)) * 1e-3).astype(np.float32)
    grid_int8 = _grid_exact(n, length, "int8")
    grid_fp8 = _grid_exact(n, length, "fp8", seed=1)
    infile = tmp_path / "in.npz"
    np.savez(infile, x=x, grid_int8=grid_int8, grid_fp8=grid_fp8,
             state=state)
    ranks = _spawn(n, tmp_path, "ring", infile)
    want = _jax_ring_functions(x, grid_int8, grid_fp8, state, n)
    keys = set(ranks[0].files)
    assert keys == set(want)
    for r, got in enumerate(ranks):
        for key in sorted(keys):
            np.testing.assert_allclose(
                got[key].astype(np.float32), want[key][r].astype(np.float32),
                rtol=0, atol=1e-6 if "sat" not in key else 0,
                err_msg=f"rank {r} {key}")
    for f in ("int8", "float8_e4m3fn"):
        for part in ("rs_", "rs_err_", "rs_sat_"):
            for r in range(n):
                np.testing.assert_allclose(
                    ranks[r][f"{part}{f}_True"], ranks[r][f"{part}{f}_False"],
                    rtol=0, atol=1e-6, err_msg=f"fused vs unfused {part}{f}")
        for r in range(1, n):      # the gathers are replicated bit for bit
            np.testing.assert_array_equal(ranks[r][f"ag_{f}"],
                                          ranks[0][f"ag_{f}"])
    true = {"int8": grid_int8.mean(0), "float8_e4m3fn": grid_fp8.mean(0)}
    chunk = length // n
    for key in (k for k in keys if k.startswith("grid_")
                and "sat" not in k):
        f = "int8" if "_int8_" in key else "float8_e4m3fn"
        for r in range(n):
            expect = true[f] if "all_reduce" in key else \
                true[f][r * chunk:(r + 1) * chunk]
            np.testing.assert_allclose(ranks[r][key], expect, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{key} rank {r}")
            assert ranks[r][key.replace("grid_", "grid_sat_")].item() == 0


# -- sessions on 8 gloo ranks against the JAX facade's 8-device mesh ----------
#: the share of a leaf's elements allowed past 1e-5 by one-quantum
#: rounding-tie flips in one step on the model's own loss
MAX_TIE_SHARE = 0.01
#: the JAX sessions' steps: the ranks take one step from each state before
JAX_STEPS = 4


def _tie_shares(got, want, atol, tie_atols, msg):
    """Per leaf, the share of elements of ``got[i]`` more than ``atol``
    from ``want[i]``.  Each share must be at most :data:`MAX_TIE_SHARE`
    (or one element, in a leaf of fewer than 100) and each leaf within
    ``tie_atols[i]``: the two frameworks' gradients
    differ in their last bits, and where a value sits at a rounding tie of
    the wire grid the two quantize it one quantum apart."""
    shares = []
    for i, (g, w, tie) in enumerate(zip(got, want, tie_atols)):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        shares.append(float((d > atol).mean()))
        assert int((d > atol).sum()) <= max(1, MAX_TIE_SHARE * d.size), \
            f"{msg} [{i}]: {shares[-1]:.2%} of {d.size} beyond {atol}"
        assert float(d.max()) <= tie, f"{msg} [{i}]: max diff {d.max()}"
    return shares


def _jax_run(params, name, linear=False):
    jax_reset()
    cap = torch_dp_worker.QUANT_BUCKET_BYTES
    builder, opt = {
        "int8_allreduce": (JAllReduce(compressor="Int8Compressor",
                                      overlap="ring", bucket_bytes=cap),
                           optax.adam(torch_dp_worker.QUANT_LR)),
        "fp8_zero1": (JZero1(cap, compressor="Fp8Compressor", overlap="ring"),
                      jax_fusable_adam(torch_dp_worker.QUANT_LR))}[name]
    jspec = jax_lm(**torch_dp_worker.QUANT_CFG, attn_fn=jax_dense)
    ad = JAutoDist(strategy_builder=builder)
    with ad.scope():
        ad.capture(params=params, optimizer=opt,
                   loss_fn=torch_dp_worker.linear_loss if linear
                   else jspec.loss_fn, sparse_vars=jspec.sparse_vars,
                   numerics={"clip_norm": torch_dp_worker.CLIP})
    return ad.create_distributed_session()


@pytest.fixture(scope="module")
def quant_sessions(tmp_path_factory):
    """Both quant runs on the JAX facade's 8-device mesh and on 8 gloo
    ranks (one spawn): ``(jax results by run, every rank's npz)``.  The
    JAX sessions run :data:`JAX_STEPS` steps and export their state before
    each, for the ranks to take one step from; each run is also trained
    for 3 steps on the linear loss."""
    tmp_path = tmp_path_factory.mktemp("quant_sessions")
    n = 8
    spec = transformer_lm(**torch_dp_worker.QUANT_CFG)
    params = params_to_numpy(spec.init(0, device="cpu"))
    batch = spec.sample_batch(8, seed=1)
    lbatch = torch_dp_worker.linear_batch(params)
    jax_out, states = {}, {r: {} for r in range(n)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AUTODIST_IS_TESTING", "True")
        for name in torch_dp_worker.quant_runs():
            jsess = _jax_run(params, name, linear=True)
            linear = ([jsess.run(lbatch) for _ in range(3)],
                      jax.tree.map(np.asarray, jsess.sync_state),
                      jax.tree.map(np.asarray, jsess.params))
            plan = torch_dp_worker.quant_session(name)[0].zero1_buckets
            jsess = _jax_run(params, name)
            runs, after = [], []
            for k in range(JAX_STEPS):
                jparams, jopt = jax.tree.map(np.asarray,
                                             jsess.export_state())
                jsync = jax.tree.map(np.asarray, jsess.sync_state)
                tparams = params_from_jax(jparams)
                for r in range(n):
                    states[r].setdefault(name, {})[k] = {
                        "params": tparams,
                        "opt_state": opt_state_from_jax(
                            jopt, zero1_buckets=plan, rank=r, data=n),
                        "sync_state": sync_state_from_jax(jsync, rank=r)}
                runs.append(jsess.run(batch))
                after.append((jax.tree.map(np.asarray, jsess.params),
                              jax.tree.map(np.asarray, jsess.sync_state)))
            algs = {b["key"]: b["alg"] for b in jsess.schedule_ir.buckets}
            jax_out[name] = dict(runs=runs, after=after, algs=algs,
                                 linear=linear)
    for r in range(n):
        torch.save(states[r], tmp_path / f"state{r}.pt")
    return jax_out, _spawn(n, tmp_path, "quant",
                           str(tmp_path / "state{rank}.pt"), timeout=400)


def _check_steps(got, prefix, runs):
    """Losses at rtol 1e-5, finiteness and saturation counts exactly."""
    for step, jm in enumerate(runs):
        np.testing.assert_allclose(got[f"{prefix}/loss/{step}"],
                                   float(jm["loss"]), rtol=1e-5)
        h = jm["grad_health"]
        assert bool(got[f"{prefix}/finite/{step}"]) == bool(h.all_finite)
        for key, entry in h.per_bucket.items():
            assert float(got[f"{prefix}/sat/{step}/{key}"]) == \
                float(entry["sat_count"]), (prefix, step, key)


def test_quant_ring_sessions_on_eight_gloo_ranks_match_jax(quant_sessions):
    """``AllReduce(Int8Compressor, ring)`` + ``adam`` and ``Zero1(
    Fp8Compressor, ring)`` + ``fusable_adam``, with clip, on 8 gloo ranks
    against the JAX facade on 8 devices.

    From the same init, 3 steps: the losses agree at rtol 1e-5, the
    saturation counts exactly, and every rank's parameters are the same
    bits.  Then one step from each of the JAX session's states after k =
    0..3 steps (imported through ``params_from_jax``,
    ``opt_state_from_jax`` and ``sync_state_from_jax``) against the JAX
    session's step k + 1: the loss and counts as before, the residuals and
    parameters at atol 1e-5 except where a rounding tie of the wire grid
    flips one quantum (the gradients of the two frameworks differ in their
    last bits; fed equal gradients the sessions agree everywhere, below):
    at most 1% of each leaf's elements (one, in a leaf of fewer than 100),
    a residual by at most one quantum, a parameter by at most one Adam
    step of the learning rate.
    Over several steps the flips feed back through the parameters, so
    they are bounded one step at a time."""
    jax_out, ranks = quant_sessions
    lr = torch_dp_worker.QUANT_LR
    for name, j in jax_out.items():
        assert sorted(ranks[0][f"{name}/algs"]) == sorted(
            f"{k}={a}" for k, a in j["algs"].items())
        assert sorted(j["algs"].values()).count("ring") == 3
        residual_keys = [k for k in j["after"][0][1] if k != "~numerics"]
        assert len(residual_keys) == len(j["algs"])
        for got in ranks:
            _check_steps(got, name, j["runs"][:3])
            for k in (k for k in got.files if k.startswith(f"{name}/p/")):
                np.testing.assert_array_equal(got[k], ranks[0][k])
        for k, (jparams, jsync) in enumerate(j["after"]):
            prefix = f"from{k}/{name}"
            for r, got in enumerate(ranks):
                _check_steps(got, prefix, j["runs"][k:k + 1])
                # a flipped quantum moves a residual by one scale, at most
                # twice the bucket's largest residual magnitude
                want = [jsync[key][r] for key in residual_keys]
                _tie_shares(
                    [got[f"{prefix}/residual/{key}"] for key in
                     residual_keys], want, 1e-5,
                    [2 * np.abs(w).max() + 1e-5 for w in want],
                    f"{prefix} rank {r} residuals")
            leaves = flatten(jparams)
            _tie_shares(
                [ranks[0][f"{prefix}/p/{pname}"] for pname, _ in leaves],
                [want for _, want in leaves], 1e-5,
                [lr + 1e-5] * len(leaves), f"{prefix} params")


def test_quant_ring_sessions_on_equal_gradients_match_jax(quant_sessions):
    """The same two runs on ``torch_dp_worker.linear_loss``, whose
    gradient at one row per rank is that row to the bit in both
    frameworks: with equal inputs to the wire, every residual and every
    parameter of every leaf agrees with the JAX session's at atol 1e-5
    after 3 steps (no tie exception), the losses at rtol 1e-5 and the
    saturation counts exactly.  This isolates the exceptions the model's
    own loss needs to the last-bit gradient differences."""
    jax_out, ranks = quant_sessions
    for name, j in jax_out.items():
        runs, jsync, jparams = j["linear"]
        prefix = f"linear/{name}"
        assert sorted(ranks[0][f"{prefix}/algs"]) == sorted(
            f"{k}={a}" for k, a in j["algs"].items())
        residual_keys = [k for k in jsync if k != "~numerics"]
        for r, got in enumerate(ranks):
            _check_steps(got, prefix, runs)
            for key in residual_keys:
                np.testing.assert_allclose(
                    got[f"{prefix}/residual/{key}"], jsync[key][r], rtol=0,
                    atol=1e-5, err_msg=f"{prefix} rank {r} residual {key}")
            assert any(np.abs(jsync[key][r]).max() > 0
                       for key in residual_keys)
        for pname, want in flatten(jparams):
            np.testing.assert_allclose(
                ranks[0][f"{prefix}/p/{pname}"], want, rtol=0, atol=1e-5,
                err_msg=f"{prefix} {pname}")
