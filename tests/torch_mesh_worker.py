"""One rank of the sharded serving engines or the sharding utilities on
gloo CPU ranks (spawned by ``tests/test_torch_serving_mesh.py`` and
``tests/test_torch_sharding_utils.py``).

    python tests/torch_mesh_worker.py RANK WORLD INIT OUT.npz IN.npz MODE

(started by ``tests/torch_launch.py``).  ``MODE``:

* ``serving`` (4 ranks; ``IN`` holds the converted weights of the two LMs
  of :data:`LMS`, ``<lm>:<name>``): the slot engine on ``{"data": 4}``
  over :func:`slot_requests` (the JAX test's), with parallel prefill and
  with sequential admission, sampled over :func:`sampled_requests` from
  a generator seeded :data:`SAMPLE_SEED`, Program G over :func:`program_g_requests`
  and its prefix pass, and the paged engine on ``{"data": 2, "model":
  2}`` (its pools sharded over the model group of 2) over
  :func:`paged_requests`, plain and with speculative rounds (the target
  as its own draft); each request's tokens and each engine's local
  buffer shapes;
* ``sharding`` (2 ranks; ``IN`` holds ``x/<name>``): ``constrain`` of
  replicated leaves on ``{"model": 2}`` (by shardings and by bare specs)
  and ``host_local`` of the shards.

Each rank runs one intra-op thread.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch  # noqa: E402

from autodist_tpu_torch.convert import params_from_jax  # noqa: E402
from autodist_tpu_torch.kernel import sharding_utils as su  # noqa: E402
from autodist_tpu_torch.mesh import build_mesh  # noqa: E402
from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.serving import (DecodeEngine,  # noqa: E402
                                        PagedDecodeEngine)

#: the LMs: the JAX engine tests' (``tests/test_serving_engine.py``) and
#: Program G's (``__graft_entry__.py``)
LMS = {"lm": dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8,
                  d_ff=32, max_len=48, seq_len=16),
       "g": dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8,
                 d_ff=64, max_len=48, seq_len=16)}
SLOTS = dict(slots=4, window=24, chunk=4)
G_SLOTS = dict(slots=4, window=32, chunk=4)
PAGED = dict(slots=2, window=32, block_size=8, num_blocks=24, chunk=4)
SLOT_AXES = {"data": 4}
PAGED_AXES = {"data": 2, "model": 2}
#: the sampled slot engine: engine-wide knobs and the generator's seed
SAMPLED = dict(temperature=1.0, top_k=8)
SAMPLE_SEED = 7
SPECS = {"w": ("model", None), "v": (None, "model"), "b": ()}


def slot_requests():
    rng = np.random.RandomState(12)
    return [(rng.randint(0, 61, p).astype(np.int32), n)
            for p, n in [(3, 5), (1, 7), (4, 4), (2, 6), (5, 3), (2, 8)]]


def sampled_requests():
    """:func:`slot_requests` at per-request temperatures (one greedy),
    then the first prompt twice more at temperature 1: identical prompts
    on different ranks' slots."""
    reqs = [(p, n, t) for (p, n), t in
            zip(slot_requests(), [1.0, 0.0, 0.7, 1.0, 1.5, 1.0])]
    first, n, _ = reqs[0]
    return reqs + [(first, n + 4, 1.0), (first, n + 4, 1.0)]


def program_g_requests(n_devices: int = 4):
    """Program G's requests, its prefix and its prefix pass (mixed
    ``use_prefix``)."""
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(0, 97, rng.randint(2, 6)).astype(np.int32),
             int(rng.randint(3, 9))) for _ in range(2 * n_devices)]
    prefix = rng.randint(0, 97, 6).astype(np.int32)
    pre = [(rng.randint(0, 97, rng.randint(2, 5)).astype(np.int32),
            int(rng.randint(3, 7)), bool(i % 2)) for i in range(n_devices)]
    return reqs, prefix, pre


def paged_requests():
    rng = np.random.RandomState(16)
    return [(rng.randint(0, 61, p).astype(np.int32), n)
            for p, n in [(3, 5), (2, 6), (4, 4), (1, 7)]]


def sharding_inputs():
    rng = np.random.RandomState(7)
    return {"w": rng.randn(4, 6).astype(np.float32),
            "v": rng.randn(3, 8).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}


def _params(inputs, lm):
    pre = lm + ":"
    return params_from_jax({k[len(pre):]: v for k, v in inputs.items()
                            if k.startswith(pre)})


def serving(inputs) -> dict:
    out = {}
    spec = transformer_lm(**LMS["lm"])
    params = _params(inputs, "lm")
    mesh = build_mesh(SLOT_AXES, device="cpu")
    eng = DecodeEngine(spec, params, **SLOTS, mesh=mesh, device="cpu")
    ids = [eng.submit(p, n) for p, n in slot_requests()]
    res = eng.run()
    out.update({f"slots/{i}": res[rid] for i, rid in enumerate(ids)})
    out["slots/tokens_shape"] = np.array(eng._tokens.shape)
    out["slots/kc_shape"] = np.array(eng._kc.shape)
    out["slots/vc_shape"] = np.array(eng._vc.shape)
    # sequential admission: each prompt written on its owner's row only
    eng = DecodeEngine(spec, params, **SLOTS, mesh=mesh, prefill=False,
                       device="cpu")
    ids = [eng.submit(p, n) for p, n in slot_requests()]
    res = eng.run()
    out.update({f"seq/{i}": res[rid] for i, rid in enumerate(ids)})
    # sampled: each rank draws the whole pool's noise and keeps its rows
    eng = DecodeEngine(spec, params, **SLOTS, **SAMPLED, mesh=mesh,
                       rng=torch.Generator().manual_seed(SAMPLE_SEED),
                       device="cpu")
    ids = [eng.submit(p, n, temperature=t) for p, n, t in sampled_requests()]
    res = eng.run()
    out.update({f"sampled/{i}": res[rid] for i, rid in enumerate(ids)})

    spec_g = transformer_lm(**LMS["g"])
    eng = DecodeEngine(spec_g, _params(inputs, "g"), **G_SLOTS, mesh=mesh,
                       device="cpu")
    reqs, prefix, pre = program_g_requests()
    ids = [eng.submit(p, n) for p, n in reqs]
    res = eng.run()
    out.update({f"g/{i}": res[rid] for i, rid in enumerate(ids)})
    eng.set_prefix(prefix)
    ids = [eng.submit(p, n, use_prefix=u) for p, n, u in pre]
    res = eng.run()
    out.update({f"gp/{i}": res[rid] for i, rid in enumerate(ids)})
    out["g/prefix_admissions"] = np.array(eng.stats.prefix_admissions)
    out["g/kc_shape"] = np.array(eng._kc.shape)

    mesh = build_mesh(PAGED_AXES, device="cpu")
    eng = PagedDecodeEngine(spec, params, **PAGED, mesh=mesh, device="cpu")
    ids = [eng.submit(p, n) for p, n in paged_requests()]
    res = eng.run()
    out.update({f"paged/{i}": res[rid] for i, rid in enumerate(ids)})
    out["paged/kc_shape"] = np.array(eng._kc.shape)
    out["paged/vc_shape"] = np.array(eng._vc.shape)
    eng.assert_no_leaks()
    # speculative rounds: the draft's pools are head-sharded too
    eng = PagedDecodeEngine(spec, params, **PAGED, mesh=mesh, device="cpu",
                            draft_spec=spec, draft_params=params, gamma=2)
    ids = [eng.submit(p, n) for p, n in paged_requests()]
    res = eng.run()
    out.update({f"spec/{i}": res[rid] for i, rid in enumerate(ids)})
    out["spec/dkc_shape"] = np.array(eng._dkc.shape)
    eng.assert_no_leaks()
    return out


def sharding(inputs) -> dict:
    mesh = build_mesh({"model": 2}, device="cpu")
    tree = {k: torch.from_numpy(inputs["x/" + k]) for k in SPECS}
    sh = su.sharding_tree(mesh, SPECS)
    local = su.constrain(tree, sh)
    by_spec = su.constrain(tree, SPECS, mesh=mesh)
    out = {f"local/{k}": v.numpy() for k, v in local.items()}
    out.update({f"spec/{k}": v.numpy() for k, v in by_spec.items()})
    out.update({f"back/{k}": v for k, v in su.host_local(local, sh).items()})
    return out


def main(rank: int, world: int, init: str, out_path: str, in_path: str,
         mode: str) -> None:
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, world, rank)
    try:
        inputs = dict(np.load(in_path))
        out = serving(inputs) if mode == "serving" else sharding(inputs)
        np.savez(out_path, **out)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5], sys.argv[6])
