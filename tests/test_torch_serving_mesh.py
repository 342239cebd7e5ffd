"""The port's serving engines on meshes against the JAX package's.

One launch of ``tests/torch_mesh_worker.py`` on 4 gloo ranks (mode
``serving``), beside the JAX engines on the conftest's CPU devices, from
the same JAX weights (``convert.params_from_jax``):

* ``DecodeEngine(mesh={"data": 4}, slots=4)``: the requests of JAX's
  ``test_engine_mesh_sharded_slots`` token-exact against JAX's sharded
  engine and the port's plain generator on every rank; each rank's token
  buffer and K/V caches hold ``slots/4`` rows; with sequential
  admission too; sampled requests bit for bit against the one-card
  engine under the same generator;
* Program G (``__graft_entry__.py``): its requests over 4 sharded slots,
  then its prefix pass with mixed ``use_prefix``, token-exact against
  JAX's engine and the generator (the prefix concatenated);
* ``PagedDecodeEngine`` on ``{"data": 2, "model": 2}``: the requests of
  JAX's ``test_paged_mesh_sharded_pool`` token-exact against JAX's engine
  on ``{"model": 2}`` and the generator; each rank's pools are ``[L, NB,
  BS, H/2, Dh]``; no block leaks; speculative rounds (the draft's pools
  head-sharded too) token-exact against the generator;
* the meshes' validation errors carry JAX's messages.

Torch runs one intra-op thread.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from autodist_tpu.models.transformer import dense_attention as jdense
from autodist_tpu.models.transformer_lm import transformer_lm as jlm
from autodist_tpu.serving import DecodeEngine as JDecodeEngine
from autodist_tpu.serving import PagedDecodeEngine as JPagedDecodeEngine
from autodist_tpu_torch.convert import params_from_jax
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.mesh import Mesh
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.transformer_lm import transformer_lm
from autodist_tpu_torch.serving import DecodeEngine, PagedDecodeEngine

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
RANKS = 4
SEEDS = {"lm": 0, "g": 3}


def _jax(lm):
    spec = jlm(**worker.LMS[lm], attn_fn=jdense)
    return spec, jax.tree.map(np.asarray,
                              spec.init(jax.random.PRNGKey(SEEDS[lm])))


def _jax_outputs(jax_lms):
    """The JAX engines' answers on the conftest's CPU devices."""
    out = {}
    spec, params = jax_lms["lm"]
    eng = JDecodeEngine(spec, params, **worker.SLOTS,
                        mesh=JMesh(np.array(jax.devices()[:4]), ("data",)))
    ids = [eng.submit(p, n) for p, n in worker.slot_requests()]
    res = eng.run()
    out.update({f"slots/{i}": np.asarray(res[r]) for i, r in enumerate(ids)})
    spec_g, params_g = jax_lms["g"]
    eng = JDecodeEngine(spec_g, params_g, **worker.G_SLOTS,
                        mesh=JMesh(np.array(jax.devices()[:4]), ("data",)))
    reqs, prefix, pre = worker.program_g_requests()
    ids = [eng.submit(p, n) for p, n in reqs]
    res = eng.run()
    out.update({f"g/{i}": np.asarray(res[r]) for i, r in enumerate(ids)})
    eng.set_prefix(prefix)
    ids = [eng.submit(p, n, use_prefix=u) for p, n, u in pre]
    res = eng.run()
    out.update({f"gp/{i}": np.asarray(res[r]) for i, r in enumerate(ids)})
    eng = JPagedDecodeEngine(spec, params, **worker.PAGED,
                             mesh=JMesh(np.array(jax.devices()[:2]),
                                        ("model",)))
    ids = [eng.submit(p, n) for p, n in worker.paged_requests()]
    res = eng.run()
    out.update({f"paged/{i}": np.asarray(res[r]) for i, r in enumerate(ids)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(JAX engines' outputs, each rank's outputs, the port's plain
    generators by LM)``: the ranks run while the JAX engines do."""
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("serving_mesh")
    jax_lms = {lm: _jax(lm) for lm in worker.LMS}
    inputs = {f"{lm}:{name}": v for lm, (_, p) in jax_lms.items()
              for name, v in flatten(p)}
    np.savez(tmp / "in.npz", **inputs)
    launch = torch_launch.Launch(
        lambda rank, init: [WORKER, rank, RANKS, init,
                            tmp / f"out{rank}.npz", tmp / "in.npz",
                            "serving"], world=RANKS, tmp_dir=tmp)
    try:
        want = _jax_outputs(jax_lms)
    finally:
        launch.wait(300)
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(RANKS)]
    gens = {lm: (make_generator(transformer_lm(**worker.LMS[lm]),
                                device="cpu"), params_from_jax(p))
            for lm, (_, p) in jax_lms.items()}
    return want, ranks, gens


def _plain(gens, lm, prompt, n):
    gen, params = gens[lm]
    return np.asarray(gen(params, prompt[None, :], n))[0]


def _check_exact(want, ranks, key, oracle):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key], want[key],
                                      err_msg=f"{key} rank {r} vs JAX")
        np.testing.assert_array_equal(out[key], oracle,
                                      err_msg=f"{key} rank {r} vs plain")


def test_slot_engine_on_data_mesh_token_exact(runs):
    want, ranks, gens = runs
    for i, (p, n) in enumerate(worker.slot_requests()):
        _check_exact(want, ranks, f"slots/{i}", _plain(gens, "lm", p, n))
    lm = worker.LMS["lm"]
    local = worker.SLOTS["slots"] // RANKS
    for out in ranks:
        assert tuple(out["slots/tokens_shape"]) \
            == (local, worker.SLOTS["window"])
        for key in ("slots/kc_shape", "slots/vc_shape"):
            assert tuple(out[key]) == (lm["num_layers"],
                                       worker.SLOTS["window"], local,
                                       lm["num_heads"], lm["head_dim"])


def test_program_g_on_data_mesh_token_exact(runs):
    want, ranks, gens = runs
    reqs, prefix, pre = worker.program_g_requests()
    for i, (p, n) in enumerate(reqs):
        _check_exact(want, ranks, f"g/{i}", _plain(gens, "g", p, n))
    for i, (p, n, use) in enumerate(pre):
        full = np.concatenate([prefix, p]) if use else p
        plain = _plain(gens, "g", full, n)
        _check_exact(want, ranks, f"gp/{i}",
                     plain[prefix.size:] if use else plain)
    for out in ranks:
        assert int(out["g/prefix_admissions"]) == sum(u for *_, u in pre)
        assert out["g/kc_shape"][2] == worker.G_SLOTS["slots"] // RANKS


def test_paged_engine_on_model_mesh_token_exact(runs):
    want, ranks, gens = runs
    for i, (p, n) in enumerate(worker.paged_requests()):
        _check_exact(want, ranks, f"paged/{i}", _plain(gens, "lm", p, n))
    lm = worker.LMS["lm"]
    for out in ranks:
        for key in ("paged/kc_shape", "paged/vc_shape"):
            assert tuple(out[key]) == (
                lm["num_layers"], worker.PAGED["num_blocks"],
                worker.PAGED["block_size"],
                lm["num_heads"] // worker.PAGED_AXES["model"],
                lm["head_dim"])


def test_slot_engine_sequential_admission_on_data_mesh(runs):
    """``prefill=False``: each prompt lands on its owner's row only, and
    the owners' rows reach every rank's host copy by the next gather."""
    _, ranks, gens = runs
    for i, (p, n) in enumerate(worker.slot_requests()):
        want = _plain(gens, "lm", p, n)
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[f"seq/{i}"], want,
                                          err_msg=f"seq/{i} rank {r}")


def test_slot_engine_sampling_on_data_mesh_matches_one_card(runs):
    """Sampled requests (per-request temperatures, engine top-k, the
    same prompt on slots of different ranks) give the one-card engine's
    tokens bit for bit under the same generator: each rank draws the
    whole pool's noise and keeps its own rows."""
    _, ranks, gens = runs
    _, params = gens["lm"]
    eng = DecodeEngine(transformer_lm(**worker.LMS["lm"]), params,
                       **worker.SLOTS, **worker.SAMPLED,
                       rng=torch.Generator().manual_seed(worker.SAMPLE_SEED),
                       device="cpu")
    reqs = worker.sampled_requests()
    ids = [eng.submit(p, n, temperature=t) for p, n, t in reqs]
    res = eng.run()
    for i, rid in enumerate(ids):
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[f"sampled/{i}"], res[rid],
                                          err_msg=f"sampled/{i} rank {r}")
    # the repeated prompt is sampled twice, not copied
    assert not np.array_equal(res[ids[-1]], res[ids[-2]])


def test_speculative_paged_engine_on_model_mesh(runs):
    """Speculative rounds with the draft's pools head-sharded too:
    greedy output equals the plain generator's on every rank."""
    _, ranks, gens = runs
    lm = worker.LMS["lm"]
    for i, (p, n) in enumerate(worker.paged_requests()):
        want = _plain(gens, "lm", p, n)
        for r, out in enumerate(ranks):
            np.testing.assert_array_equal(out[f"spec/{i}"], want,
                                          err_msg=f"spec/{i} rank {r}")
    for out in ranks:
        assert out["spec/dkc_shape"][3] \
            == lm["num_heads"] // worker.PAGED_AXES["model"]


def test_mesh_validation_errors_are_jax_messages():
    spec, params = _jax("lm")
    port_spec, port_params = transformer_lm(**worker.LMS["lm"]), \
        params_from_jax(params)
    four = JMesh(np.array(jax.devices()[:4]), ("data",))
    pfour = Mesh(shape={"data": 4}, device=torch.device("cpu"))
    two = JMesh(np.array(jax.devices()[:2]), ("model",))
    ptwo = Mesh(shape={"model": 2}, device=torch.device("cpu"))
    cases = [
        (lambda: JDecodeEngine(spec, params, slots=3, window=24, mesh=four),
         lambda: DecodeEngine(port_spec, port_params, slots=3, window=24,
                              mesh=pfour, device="cpu")),
        (lambda: JDecodeEngine(spec, params, slots=4, window=24, mesh=four,
                               slot_axis="model"),
         lambda: DecodeEngine(port_spec, port_params, slots=4, window=24,
                              mesh=pfour, slot_axis="model", device="cpu")),
        (lambda: JPagedDecodeEngine(spec, params, **worker.PAGED, mesh=two,
                                    model_axis="data"),
         lambda: PagedDecodeEngine(port_spec, port_params, **worker.PAGED,
                                   mesh=ptwo, model_axis="data",
                                   device="cpu")),
    ]
    for jcall, call in cases:
        with pytest.raises(ValueError) as jerr:
            jcall()
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(jerr.value)
