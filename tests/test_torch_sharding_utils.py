"""The port's sharding-tree utilities (``autodist_tpu_torch.kernel.
sharding_utils``) against the JAX package's.

* the pad helpers (``pad_info_tree``, ``pad_tree``, ``unpad_tree``,
  ``mask_pad_tree``, ``unpad_host_tree``) equal JAX's bit for bit on
  padded and unpadded leaves, the info strings exactly;
* ``spec_tree_for_params`` and ``opt_spec_tree`` (over Adam's state:
  the moments take the parameter specs, the count the default) give
  JAX's trees of specs; ``abstract_like`` keeps shapes and dtypes;
* on 2 gloo ranks (one launch of ``tests/torch_mesh_worker.py``, mode
  ``sharding``): ``constrain`` cuts each rank's shard of a replicated
  leaf on ``{"model": 2}`` (by shardings and by bare specs), and
  ``host_local`` of the shards gives the leaf back.

Torch runs one intra-op thread.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from autodist_tpu.kernel import sharding_utils as jsu
from autodist_tpu_torch import optim
from autodist_tpu_torch.graph_item import flatten
from autodist_tpu_torch.kernel import sharding_utils as su

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_launch  # noqa: E402
import torch_mesh_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
#: name -> (axis, logical, padded); "dense/bias" is left unpadded
PAD_MAP = {"embed": (0, 5, 8), "dense/kernel": (1, 3, 4)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _params():
    rng = np.random.RandomState(0)
    return {"embed": rng.randn(5, 4).astype(np.float32),
            "dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)}}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _np(tree):
    return {n: np.asarray(v) for n, v in flatten(tree)}


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _same_bits(got, want):
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want)
    for n, v in got.items():
        assert v.shape == want[n].shape and v.dtype == want[n].dtype \
            and v.tobytes() == want[n].tobytes(), n


def test_pad_helpers_match_jax_bit_for_bit():
    params = _params()
    info = su.pad_info_tree(params, PAD_MAP)
    jinfo = jsu.pad_info_tree(params, PAD_MAP)
    assert dict(flatten(info)) == dict(flatten(jinfo)) == {
        "embed": "0:5:8", "dense/kernel": "1:3:4", "dense/bias": ""}
    padded = su.pad_tree(_torch(params), info)
    jpadded = _numpy_tree(jsu.pad_tree(params, jinfo))
    _same_bits(padded, jpadded)
    # a pad region that is not zero, masked back to zero
    dirty = {"embed": jpadded["embed"] + 1,
             "dense": {"kernel": jpadded["dense"]["kernel"] - 2,
                       "bias": jpadded["dense"]["bias"]}}
    _same_bits(su.mask_pad_tree(_torch(dirty), info),
               jsu.mask_pad_tree(jax.tree.map(jnp.asarray, dirty), jinfo))
    for got in (su.unpad_tree(padded, info),
                jsu.unpad_tree(jax.tree.map(jnp.asarray, jpadded), jinfo),
                su.unpad_host_tree(jpadded, info),
                jsu.unpad_host_tree(jpadded, jinfo)):
        _same_bits(got, params)


def test_unpad_is_differentiable_with_zero_pad_gradients():
    params = _torch(_params())
    info = su.pad_info_tree(params, PAD_MAP)
    padded = {k: v for k, v in flatten(su.pad_tree(params, info))}
    leaf = padded["embed"].requires_grad_()
    out = su.unpad_tree({"embed": leaf}, {"embed": "0:5:8"})["embed"]
    (g,) = torch.autograd.grad(out.sum(), leaf)
    assert torch.equal(g[:5], torch.ones(5, 4))
    assert torch.equal(g[5:], torch.zeros(3, 4))


def test_spec_trees_match_jax():
    params = _params()
    specs = {"embed": ("model", None), "dense/kernel": (None, "model")}
    jspecs = {k: P(*v) for k, v in specs.items()}
    tree = su.spec_tree_for_params(params, specs)
    jtree = jsu.spec_tree_for_params(params, jspecs)
    assert dict(flatten(tree)) == {
        n: tuple(v) for n, v in flatten(jax.tree.map(
            tuple, jtree, is_leaf=lambda x: isinstance(x, P)))}
    state = optim.adam(1e-3).init(_torch(params))
    jstate = optax.adam(1e-3).init(params)
    got = su.opt_spec_tree(state, params, tree)
    jgot = jsu.opt_spec_tree(jstate, params, jtree)
    jadam = jgot[0]              # optax's chain: (ScaleByAdamState, ...)
    assert got["count"] == tuple(jadam.count) == ()
    for slot in ("mu", "nu"):
        assert got[slot] == tree
        assert dict(flatten(got[slot])) == {
            n: tuple(v) for n, v in flatten(jax.tree.map(
                tuple, getattr(jadam, slot),
                is_leaf=lambda x: isinstance(x, P)))}
    # a pad-info tree projected onto the state as JAX does it
    info = su.pad_info_tree(params, PAD_MAP)
    assert su.opt_spec_tree(state, params, info, default="") == {
        "count": "", "mu": info, "nu": info}


def test_abstract_like_keeps_shapes_and_dtypes():
    tree = {"a": torch.zeros(3, 2, dtype=torch.bfloat16),
            "b": {"c": np.zeros((4,), np.int32)}, "d": None}
    meta = su.abstract_like(tree)
    assert meta["a"].device.type == "meta" and meta["a"].shape == (3, 2) \
        and meta["a"].dtype == torch.bfloat16
    assert meta["b"]["c"].shape == (4,) and meta["b"]["c"].dtype \
        == torch.int32
    assert meta["d"] is None


def test_constrain_and_host_local_on_gloo_ranks(tmp_path):
    inputs = worker.sharding_inputs()
    np.savez(tmp_path / "in.npz", **{"x/" + k: v for k, v in inputs.items()})
    torch_launch.run(
        lambda rank, init: [WORKER, rank, 2, init, tmp_path / f"out{rank}.npz",
                            tmp_path / "in.npz", "sharding"],
        world=2, tmp_dir=tmp_path, timeout=120)
    for rank in range(2):
        out = np.load(tmp_path / f"out{rank}.npz")
        for name, x in inputs.items():
            spec = worker.SPECS[name]
            want = x
            for dim, axis in enumerate(spec):
                if axis == "model":
                    size = x.shape[dim] // 2
                    want = np.take(want, range(rank * size,
                                               (rank + 1) * size), axis=dim)
            assert np.array_equal(out[f"local/{name}"], want), (rank, name)
            assert np.array_equal(out[f"spec/{name}"], want), (rank, name)
            assert np.array_equal(out[f"back/{name}"], x), (rank, name)
