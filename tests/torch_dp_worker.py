"""One rank of a data-parallel run of the port on gloo CPU ranks (spawned by
``tests/test_torch_training.py``, ``tests/test_torch_zero1.py``,
``tests/test_torch_quant_ring.py``, ``tests/test_torch_ps_family.py``,
``tests/test_torch_models.py`` and ``tests/test_torch_checkpoint.py``).

    python tests/torch_dp_worker.py RANK WORLD INIT OUT.npz [MODE [IN]]

(started by ``tests/torch_launch.py``; ``INIT`` is the group's init
method, a ``file://`` store).

Trains a tiny ``transformer_lm`` for 3 steps on the same global batch of 8
rows, then writes the losses, the final parameters and the bucket count
to ``OUT.npz``.  The default strategy is ``AllReduce()`` with
``adam(1e-2)``.  ``zero1`` trains with ``Zero1(4096)``, ``fusable_adam(1e-2)``
and ``numerics={"clip_norm": 1.0}``, and also writes the global norms,
this rank's ZeRO-1 shard sizes and the logical state ``export_state``
gives; with ``IN`` (a ``torch.save`` file of ``{"params", "opt_state",
"sync_state", "step"}`` per rank, keyed by rank) it then imports that
state into a fresh session and writes the losses of 2 more steps.

``ps`` trains the PS family in one launch (``IN``: the case matrix's
parameters and batches, :func:`ps_main`): the model under each of
:data:`PS_LM_BUILDERS` with ``fusable_adam(1e-2)`` and ``numerics=
{"clip_norm": 1.0}``, every case of :data:`CASES` under every builder of
:data:`CASE_BUILDERS`, and every one of :data:`REFERENCE_VARIANTS` on
``scan``, each case with ``adam(1e-2)`` for 3 steps.  ``ps_model`` (4
ranks, the same ``IN``) trains every case under every builder on
``{"data": 2, "model": 2}`` (:func:`ps_model_main`).

``models`` trains each BASELINE configuration of :data:`MODEL_RUNS` (a
tiny model of each family under its builder and optimizer, NCF's under
``PSLoadBalancing`` with ``fusable_adam`` and the clip) for 3 steps
from ``IN``'s weights on ``IN``'s global batch (``{name}/p/{variable}``,
``{name}/b/{key}``), and writes the losses, the parameters, the step's
fused kernels and lm1b's adagrad state as ``export_state`` gives it.

``storage`` trains every case of :data:`STORAGE_CASES` (variables stored
1/N between steps) from ``IN``'s weights for 3 steps and writes the
logical state and this rank's stored parts (:func:`storage_main`); it
also saves checkpoints under ``CKPT`` (the 8th argument) for a 1-rank
restore, restores the test's 1-rank ones, and runs a numerics rollback.

``quant`` trains :data:`QUANT_CFG` under each of :func:`quant_runs` (the
quantized ring, ``numerics={"clip_norm": 1.0}``) for 3 steps and writes
losses, saturation counts, parameters and this rank's error-feedback
residuals; then the same after one step from each of the states in
``IN`` (a path with ``{rank}``: this rank's ``torch.save`` file of
``{run name: {k: {"params", "opt_state", "sync_state"}}}``, the state
after k steps); then after 3 steps on :func:`linear_loss` and
:func:`linear_batch`, whose gradients are the batch's rows to the bit.  ``ring`` runs the quantized ring collectives
on the rows of ``IN.npz`` (:func:`ring_functions`).

``levers`` trains what ``IN`` holds (:func:`levers_main`): the remat
model (:data:`REMAT_CFG`, ``remat/...`` weights and batch) under each of
:data:`REMAT_POLICIES` with ``AllReduce()`` and ``adam(1e-2)``, and the
two-layer problem (``zero1/...``) under ``Zero1()`` with ``adam(1e-2)``
and with ``cast_opt_state(adam(1e-2))``.

``ckpt`` trains each run of :func:`ckpt_runs` through ``fit`` for
:data:`CKPT_EPOCHS` epochs uninterrupted, then again with a checkpoint
after epoch 1 under ``IN/{run}`` (rank 0 writes), a fresh session and a
``fit(resume=True)`` to the same total, and writes both runs' epoch
losses and parameters; then the rollback policy's run with and without
two poisoned steps (:func:`ckpt_main`).

``p6`` runs the P6 options (:func:`p6_main`; ``IN``: a ``torch.save``
file of :func:`p6_inputs`' arrays and the JAX PowerSGD state per rank):
the compressors' ``reduce``/``reduce_scatter`` on the rows of ``IN``,
:data:`P6_COMPRESSORS` on :func:`lin_problem` (5 steps, and 60 for
convergence), Program E (:func:`prog_e_problem`), fused groups, bounded
staleness and proxies on :func:`stale_problem`, the accumulation pipeline
on the LM (even and uneven microbatches, ``Int8Compressor`` per slot) and,
at 4 ranks, ``hier`` on :func:`hier_problem` (f32 and the int8 DCN wire)
and a ``hier`` checkpoint restored into a flat session and back.

``telemetry`` (2 ranks; ``IN``: a directory) mirrors the JAX package's
session telemetry tests (:func:`telemetry_main`): step records flushed to
``AUTODIST_TELEMETRY_DIR``, ``AUTODIST_TRACE_AT`` windows, ``fit``'s
phases and goodput, and losses with telemetry on and off.  ``spans`` (4
ranks) runs one step of each of :func:`span_runs` under a CPU
``torch.profiler`` and writes the ``autodist_sync/`` range names and
counts it records (:func:`spans_main`).

``auto`` (4 ranks; ``IN``: the JAX weights ``p:<name>`` and the batch
``b:<key>``) builds ``AutoStrategy(search="beam")`` on a 4-chip spec
under the calibration ``AUTODIST_CALIBRATION`` names,
``create_distributed_session(validate=True)``, trains ``fusable_adam``
and the clip for 3 steps and writes the losses, the parameters,
``last_choice``, the strategy's id and the schedule fingerprint
(:func:`auto_main`).  Every rank but 0 lets its search price one
candidate (``max_evals=1``): a rank that searched on its own would stop
there, as a search stops on its wall-clock budget on a slower host, and
would pick another plan.

``tune`` (4 ranks, no ``IN``) trains ``AllReduce`` 3 steps, feeds rank 0
drifted leg samples and the others on-model ones, runs
``ScheduleTuner.maybe_retune`` on every rank and 3 more steps, asks a
swap with a rank-local strategy on rank 1, replays the swap step's
snapshot on an oracle session of the winner, and restores a
``PSLoadBalancing`` session (its ``embed`` stored 1/N) from a snapshot
(:func:`tune_main`).

Each rank runs one intra-op thread: ranks do not contend for the host's
cores, and the sums come out the same on any host.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch  # noqa: E402

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch.autodist import (  # noqa: E402
    AutoDist, _reset_default_autodist_for_testing)
from autodist_tpu_torch.graph_item import flatten, unflatten  # noqa: E402
from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.ops.fused_kernels import fusable_adam  # noqa: E402
from autodist_tpu_torch import strategy as port_strategy  # noqa: E402
from autodist_tpu_torch.strategy import (PS, AllReduce,  # noqa: E402
                                         Parallax, PartitionedPS,
                                         PSLoadBalancing,
                                         RandomAxisPartitionAR,
                                         UnevenPartitionedPS, Zero1)

CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
           max_len=16)
STEPS = 3
CLIP = 1.0
#: the ZeRO-1 bucket cap of the ``zero1`` run: small, so the tiny model
#: spreads over several buckets
ZERO1_BUCKET_BYTES = 1 << 12
#: the ``quant`` runs' model: the embedding and both MLP kernels are 65,536
#: elements, so at a 256 KiB cap they are three buckets at the quantized
#: ring's threshold; the attention and norm variables make one bucket
#: below it (the one-shot tier)
QUANT_CFG = dict(vocab_size=1024, num_layers=1, num_heads=2, head_dim=32,
                 d_ff=1024, max_len=16)
QUANT_BUCKET_BYTES = 256 << 10
QUANT_LR = 1e-3
#: the equal-gradient runs' batch: numpy's seed and the rows' scale
LINEAR_SEED, LINEAR_SCALE = 3, 1e-2


#: the ``ps`` mode's builders of the model (by name, with no arguments)
PS_LM_BUILDERS = ("PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
                  "Parallax", "PartitionedAR")
#: the case matrix (``tests/test_case_matrix.py``): its cases on a data-only
#: mesh, under all 8 builders (``bf16_remat`` with ``capture(remat="dots")``)
CASES = ("sparse", "scan", "bf16_remat", "while_loop", "dynamic_lstm")
CASE_BUILDERS = ("PS", "PSLoadBalancing", "PartitionedPS",
                 "UnevenPartitionedPS", "AllReduce", "PartitionedAR",
                 "RandomAxisPartitionAR", "Parallax")
CASE_LR = 1e-2
#: the JAX package's reference-variant list
#: (``tests/test_case_matrix.py:263-274``), every one trained on ``scan``
REFERENCE_VARIANTS = (
    lambda: PS(),
    lambda: PartitionedPS(local_proxy_variable=True),
    lambda: AllReduce(chunk_size=1, all_reduce_spec="NCCL",
                      compressor="NoneCompressor"),
    lambda: AllReduce(chunk_size=1, all_reduce_spec="NCCL",
                      compressor="HorovodCompressor"),
    lambda: AllReduce(chunk_size=1, all_reduce_spec="RING",
                      compressor="HorovodCompressorEF"),
    lambda: PSLoadBalancing(local_proxy_variable=True),
    lambda: Parallax(local_proxy_variable=True),
    lambda: PSLoadBalancing(),
    lambda: UnevenPartitionedPS(local_proxy_variable=True),
    lambda: RandomAxisPartitionAR(chunk_size=4),
)


def case_loss(case):
    """The PyTorch twin of the case matrix's ``loss_fn`` for ``case``.
    ``while_loop``'s stopping test reads the max over the GLOBAL batch,
    as the JAX step's does on a data-sharded batch: an all_reduce over the
    ranks when there are several."""
    mse = lambda pred, y: ((pred - y) ** 2).mean()  # noqa: E731
    if case == "sparse":
        def loss(p, b):
            h = p["emb"]["table"][b["ids"].long()]
            return mse(h.mean(1) @ p["head"]["w"], b["y"])
    elif case == "scan":
        def loss(p, b):
            h = b["x"].new_zeros(b["x"].shape[0], p["cell"]["w_h"].shape[0])
            for x_t in b["x"].transpose(0, 1):
                h = torch.tanh(x_t @ p["cell"]["w_x"] + h @ p["cell"]["w_h"])
            return mse(h @ p["proj"]["w"], b["y"])
    elif case == "bf16_remat":
        def loss(p, b):
            h = torch.tanh(b["x"] @ p["l1"]["w"])
            return mse((h @ p["l2"]["w"]).float(), b["y"].float())
    elif case == "while_loop":
        def loss(p, b):
            i, v = 0, b["x"].detach()
            while i < 8:
                m = v.abs().max()
                if dist.is_initialized():
                    dist.all_reduce(m, op=dist.ReduceOp.MAX)
                if not m > 1.05:
                    break
                i, v = i + 1, 0.7 * v
            return mse(torch.tanh(v) @ p["lin"]["w"], b["y"])
    elif case == "dynamic_lstm":
        def loss(p, b):
            x = b["x"].transpose(0, 1)                 # [T, B, d_in]
            live = (torch.arange(x.shape[0])[:, None]
                    < b["len"][None, :]).to(x.dtype)   # [T, B]
            h = c = x.new_zeros(x.shape[1], p["lstm"]["w_h"].shape[0])
            for x_t, m in zip(x, live[:, :, None]):
                z = x_t @ p["lstm"]["w_x"] + h @ p["lstm"]["w_h"] \
                    + p["lstm"]["b"]
                i, f, g, o = z.chunk(4, dim=-1)
                nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                nh = torch.sigmoid(o) * torch.tanh(nc)
                h, c = m * nh + (1 - m) * h, m * nc + (1 - m) * c
            return mse(h @ p["proj"]["w"], b["y"])
    else:
        raise ValueError(f"unknown case {case!r}")
    return loss


def case_losses(case, builder, data, mesh_axes=None):
    """3 ``adam`` steps of ``case`` under ``builder`` (on ``mesh_axes``,
    default pure data parallelism): the losses.  ``data`` holds
    ``{case}/p/{name}`` and ``{case}/b/{key}`` arrays, a bfloat16 one as
    its 16-bit payload under ``...:bfloat16``."""
    _reset_default_autodist_for_testing()
    part = {}
    for k in data.files:
        if k.startswith(case + "/"):
            name, _, dtype = k[len(case) + 1:].partition(":")
            t = torch.from_numpy(data[k])
            part[name] = t.view(torch.bfloat16) if dtype == "bfloat16" else t
    params = unflatten([(k[2:], v) for k, v in part.items()
                        if k.startswith("p/")])
    batch = {k[2:]: v for k, v in part.items() if k.startswith("b/")}
    ad = AutoDist(strategy_builder=builder, device="cpu",
                  mesh_axes=mesh_axes)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.adam(CASE_LR),
                   loss_fn=case_loss(case),
                   sparse_vars=("emb/table",) if case == "sparse" else (),
                   remat="dots" if case == "bf16_remat" else None)
    sess = ad.create_distributed_session()
    return np.array([float(sess.run(batch)["loss"]) for _ in range(STEPS)])


#: the ``ps_model`` mode's mesh: the case matrix's ``dp4tp2`` cell on 4
#: ranks
CASE_MODEL_AXES = {"data": 2, "model": 2}


def ps_model_main(data):
    """The ``ps_model`` mode: every case of :data:`CASES` under every
    builder of :data:`CASE_BUILDERS` on :data:`CASE_MODEL_AXES`."""
    import warnings

    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # padded shardings replicated
        for case in CASES:
            for name in CASE_BUILDERS:
                out[f"case/{case}/{name}"] = case_losses(
                    case, getattr(port_strategy, name)(), data,
                    CASE_MODEL_AXES)
    return out


#: the ``levers`` mode's remat model (``tests/test_remat.py``'s) and its
#: policies (None: no remat)
REMAT_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
                 d_ff=32, max_len=16, seq_len=16)
REMAT_POLICIES = (None, "full", "dots", "dots_no_batch")
#: the ``levers`` mode's ZeRO-1 steps with bf16 moments
BF16_STEPS = 30


def levers_main(data):
    """The ``levers`` mode: the remat losses per policy, and the bf16
    moments' losses, dtypes and bytes of this rank's state."""
    from autodist_tpu_torch.ops.opt_state_dtype import cast_opt_state

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(data[k])
                for k in data.files if k.startswith(prefix)}

    out = {}
    spec = transformer_lm(**REMAT_CFG)
    batch = {"tokens": data["remat/b/tokens"]} \
        if "remat/b/tokens" in data.files else None
    for policy in REMAT_POLICIES if batch is not None else ():
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
        with ad.scope():
            ad.capture(params=unflatten(list(part("remat/p/").items())),
                       optimizer=optim.adam(CASE_LR), loss_fn=spec.loss_fn,
                       remat=policy)
        sess = ad.create_distributed_session()
        out[f"remat/{policy}"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(STEPS)])

    zbatch = part("zero1/b/")
    for name, opt in (("f32", optim.adam(CASE_LR)),
                      ("bf16", cast_opt_state(optim.adam(CASE_LR))))\
            if zbatch else ():
        _reset_default_autodist_for_testing()
        ad = AutoDist(strategy_builder=Zero1(), device="cpu")
        with ad.scope():
            ad.capture(params=unflatten(list(part("zero1/p/").items())),
                       optimizer=opt, loss_fn=lambda p, b: ((torch.tanh(
                           b["x"] @ p["l1"]["w"] + p["l1"]["b"])
                           @ p["l2"]["w"] - b["y"]) ** 2).mean())
        sess = ad.create_distributed_session()
        leaves = [v for _, v in flatten(sess.opt_state)]
        out[f"zero1/{name}/bytes"] = sum(v.numel() * v.element_size()
                                         for v in leaves)
        out[f"zero1/{name}/dtypes"] = np.array(sorted(
            {f"{v.dim()}:{v.dtype}" for v in leaves}))
        out[f"zero1/{name}/losses"] = np.array(
            [float(sess.run(zbatch)["loss"]) for _ in range(BF16_STEPS)])
    return out


def ps_main(data):
    """The ``ps`` mode: ``{key: array}`` of every run (see the module
    docstring)."""
    import warnings

    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # adam's unfused shard update
        for name in PS_LM_BUILDERS:
            sess, batch = session(name)
            results = [sess.run(batch) for _ in range(STEPS)]
            out[f"lm/{name}/losses"] = np.array(
                [float(r["loss"]) for r in results])
            out[f"lm/{name}/norms"] = np.array(
                [float(r["grad_health"].global_norm) for r in results])
            out.update({f"lm/{name}/p:{k}": v
                        for k, v in flatten(sess.params)})
            if sess.zero1_buckets:
                _, exported = sess.export_state()
                z = sess.opt_state["zero1"]
                out.update({f"lm/{name}/shard:{k}": v.numel()
                            for k, v in z["mu"].items()})
                out.update({f"lm/{name}/full_{m}:{k}": v.numpy()
                            for m in ("mu", "nu")
                            for k, v in exported["zero1"][m].items()})
        for case in CASES:
            for name in CASE_BUILDERS:
                out[f"case/{case}/{name}"] = case_losses(
                    case, getattr(port_strategy, name)(), data)
        for i in range(len(REFERENCE_VARIANTS)):
            out[f"variant/{i}"] = case_losses("scan", REFERENCE_VARIANTS[i](),
                                              data)
    return out


#: the ``models`` mode's tiny models: each family's factory arguments
MODEL_CFGS = {
    "resnet": dict(stage_sizes=(1, 2, 1, 1), num_classes=8, image_size=32),
    "vgg": dict(num_classes=8, image_size=32),
    "bert": dict(vocab_size=512, num_layers=2, num_heads=2, head_dim=16,
                 d_ff=64, max_len=64, seq_len=16),
    "lm1b": dict(vocab_size=512, emb_dim=32, hidden_dim=64, num_layers=2,
                 seq_len=8, xent_chunk=128),
    "ncf": dict(num_users=64, num_items=32, mf_dim=8, mlp_dims=(32, 16, 8)),
    "densenet": dict(num_classes=8, image_size=32),
    "inception": dict(num_classes=8, image_size=75),
}
#: each BASELINE configuration (BASELINE.json): builder name, optimizer name
#: and arguments (the same names in the port's ``optim`` and in the JAX
#: package's optimizer library; ``fusable_adam`` from each package's
#: ``ops.fused_kernels``), ``capture(numerics=...)``
MODEL_RUNS = {
    "resnet": ("AllReduce", "sgd", dict(learning_rate=1e-2, momentum=0.9),
               None),
    "vgg": ("PartitionedPS", "sgd", dict(learning_rate=1e-2, momentum=0.9),
            {"clip_norm": CLIP}),
    "bert": ("PartitionedAR", "adamw", dict(learning_rate=1e-3), None),
    "lm1b": ("Parallax", "adagrad", dict(learning_rate=0.1), None),
    "ncf": ("PSLoadBalancing", "fusable_adam", dict(lr=1e-3),
            {"clip_norm": CLIP}),
}
MODEL_BATCH = 8


def model_spec(name, **over):
    """The port's spec of :data:`MODEL_CFGS` ``name``, its arguments
    updated by ``over`` (ResNet's ``stem`` too)."""
    from autodist_tpu_torch.models import (bert, densenet121, inception_v3,
                                           lm1b, ncf, vgg16)
    from autodist_tpu_torch.models.resnet import ResNet, _image_spec

    cfg = dict(MODEL_CFGS[name], **over)
    if name == "resnet":
        model = ResNet(cfg.pop("stage_sizes"), cfg["num_classes"],
                       stem=cfg.pop("stem", "conv7"))
        return _image_spec("resnet", model, **cfg)
    return {"vgg": vgg16, "bert": bert, "lm1b": lm1b, "ncf": ncf,
            "densenet": densenet121, "inception": inception_v3}[name](**cfg)


def models_main(data):
    """The ``models`` mode: ``{key: array}`` of every run."""
    import warnings

    out = {}
    for name, (builder, opt, kw, numerics) in MODEL_RUNS.items():
        _reset_default_autodist_for_testing()
        part = {k[len(name) + 1:]: data[k] for k in data.files
                if k.startswith(name + "/")}
        params = unflatten([(k[2:], torch.from_numpy(v))
                            for k, v in part.items() if k.startswith("p/")])
        batch = {k[2:]: v for k, v in part.items() if k.startswith("b/")}
        spec = model_spec(name)
        optimizer = fusable_adam(**kw) if opt == "fusable_adam" \
            else getattr(optim, opt)(**kw)
        ad = AutoDist(strategy_builder=getattr(port_strategy, builder)(),
                      device="cpu")
        with ad.scope():
            ad.capture(params=params, optimizer=optimizer,
                       loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                       numerics=numerics)
        sess = ad.create_distributed_session()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # sgd's unfused shard update
            out[f"{name}/losses"] = np.array(
                [float(sess.run(batch)["loss"]) for _ in range(STEPS)])
        out.update({f"{name}/p:{k}": v for k, v in flatten(sess.params)})
        out[f"{name}/fused_kernels"] = np.array(sess._step.fused_kernels,
                                                dtype=str)
        if opt == "adagrad":
            _, exported = sess.export_state()
            out.update({f"{name}/zero1:{k}": v.numpy() for k, v in
                        exported["zero1"]["sum_of_squares"].items()})
            out.update({f"{name}/vars:{k}": v.numpy() for k, v in flatten(
                exported["vars"]["sum_of_squares"])})
    return out


def quant_runs():
    """``{name: (builder, optimizer)}`` of the ``quant`` mode."""
    return {"int8_allreduce": (
                AllReduce(compressor="Int8Compressor", overlap="ring",
                          bucket_bytes=QUANT_BUCKET_BYTES),
                optim.adam(QUANT_LR)),
            "fp8_zero1": (
                Zero1(QUANT_BUCKET_BYTES, compressor="Fp8Compressor",
                      overlap="ring"),
                fusable_adam(QUANT_LR))}


def linear_batch(params):
    """A global batch of 8 rows, ``{parameter name: [8, *shape]}`` f32
    from numpy: row r holds one value per parameter element."""
    rng = np.random.default_rng(LINEAR_SEED)
    return {name: (rng.standard_normal((8,) + tuple(leaf.shape))
                   * LINEAR_SCALE).astype(np.float32)
            for name, leaf in flatten(params)}


def linear_loss(params, batch):
    """``sum over parameters of <p, mean of batch[name] over the rows>``:
    linear in the parameters, so at one row per rank the gradient is that
    row to the bit, in PyTorch and in JAX alike (torch tensors or JAX
    arrays)."""
    return sum((leaf * batch[name].mean(0)).sum()
               for name, leaf in flatten(params))


def quant_session(name, device="cpu", linear=False):
    """A fresh facade session of quant run ``name`` and its batch (with
    ``linear``, on :func:`linear_loss` and :func:`linear_batch`)."""
    _reset_default_autodist_for_testing()
    builder, opt = quant_runs()[name]
    spec = transformer_lm(**QUANT_CFG)
    params = spec.init(0, device=device)
    ad = AutoDist(strategy_builder=builder, device=device)
    with ad.scope():
        ad.capture(params=params, optimizer=opt,
                   loss_fn=linear_loss if linear else spec.loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP})
    batch = linear_batch(params) if linear else spec.sample_batch(8, seed=1)
    return ad.create_distributed_session(), batch


def ring_functions(x, grid_int8, grid_fp8, state, group, n):
    """Every quantized ring function on this rank's rows:
    ``{name: array}`` (scalars as 1-element arrays)."""
    from autodist_tpu_torch.kernel.synchronization import quant_ring as qr
    from autodist_tpu_torch.kernel.synchronization.compressor import \
        get_compressor

    out = {}
    for fmt in (qr.WIRE_INT8, qr.WIRE_FP8_E4M3):
        f = fmt.name
        for fused in (False, True):
            red, err, sat = qr.quantized_ring_reduce_scatter(
                x, group, n, fmt, fused=fused)
            out.update({f"rs_{f}_{fused}": red, f"rs_err_{f}_{fused}": err,
                        f"rs_sat_{f}_{fused}": sat})
        out[f"ag_{f}"], out[f"ag_sat_{f}"] = qr.quantized_ring_all_gather(
            red / n, group, n, fmt)
        (out[f"a2a_{f}"], out[f"a2a_err_{f}"],
         out[f"a2a_sat_{f}"]) = qr.quantized_all_to_all_reduce_scatter(
            x, group, n, fmt)
        out[f"qag_{f}"], out[f"qag_sat_{f}"] = qr.quantized_all_gather(
            out[f"a2a_{f}"] / n, group, n, fmt)
        grid = grid_int8 if f == "int8" else grid_fp8
        for mode in ("all_reduce", "reduce_scatter"):
            for alg in ("ring", "fused"):
                for fused in ((False, True) if alg == "ring" else (False,)):
                    tag = f"{f}_{mode}_{alg}_{fused}"
                    (out[f"qbr_{tag}"], out[f"qbr_state_{tag}"],
                     out[f"qbr_sat_{tag}"]) = qr.quant_bucket_reduce(
                        x, state, group, n, fmt, mode=mode, alg=alg,
                        fused=fused)
                    out[f"grid_{tag}"], _, out[f"grid_sat_{tag}"] = \
                        qr.quant_bucket_reduce(
                            grid, torch.zeros_like(grid), group, n, fmt,
                            mode=mode, alg=alg, fused=fused)
    for name in ("Int8Compressor", "NoneCompressor"):
        comp = get_compressor(name)
        st = comp.init_state(x)
        out[f"c_red_{name}"], st2 = comp.reduce(x.reshape(n, -1), st if st
                                                is None else st.reshape(n, -1),
                                                group, n)
        out[f"c_rs_{name}"], st3 = comp.reduce_scatter(x, st, group, n)
        if st2 is not None:
            out[f"c_red_state_{name}"], out[f"c_rs_state_{name}"] = st2, st3
    return {k: (v.view(torch.uint8) if v.element_size() == 1
                and v.dtype != torch.int8 else v).reshape(-1).numpy()
            for k, v in out.items()}


#: the ``ckpt`` mode's epochs (2 steps each); the checkpoint is taken after
#: the first
CKPT_EPOCHS = 3


def ckpt_runs():
    """``{name: () -> (session, batch)}`` of the ``ckpt`` mode: the plain
    step, ZeRO-1, the facade's default, the Int8 ring (residuals in the
    sync state), the bf16 wire with error feedback, PowerSGD (per-variable
    state) and bounded staleness (the delay queue)."""
    return {"allreduce": lambda: session("allreduce"),
            "zero1": lambda: session("zero1"),
            "PSLoadBalancing": lambda: session("PSLoadBalancing"),
            "int8_allreduce": lambda: quant_session("int8_allreduce"),
            "horovod_ef": lambda: lm_session(
                AllReduce(compressor="HorovodCompressorEF")),
            "powersgd": lambda: lm_session(
                AllReduce(compressor="PowerSGDCompressor")),
            "ps_stale": lambda: lm_session(PS(staleness=2),
                                           opt=fusable_adam(1e-2))}


def lm_session(builder, opt=None, accum=1, cfg=None, bucket=None,
               numerics=None, rows=8):
    """A facade session of the LM (:data:`CFG`, or ``cfg``) under
    ``builder`` (``adam(1e-2)`` unless ``opt``), and its batch of
    ``rows``."""
    import warnings

    torch.manual_seed(0)
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**(cfg or CFG))
    ad = AutoDist(strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=opt or optim.adam(1e-2), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars, accum_steps=accum,
                   numerics=numerics)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the JAX fallbacks' warnings
        sess = ad.create_distributed_session()
    return sess, spec.sample_batch(rows, seed=1)


def rollback_session():
    """``Zero1`` with ``on_nonfinite="rollback"`` on the loss times the
    batch's ``s`` column (NaN poisons a step), and the clean batch."""
    torch.manual_seed(0)
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)

    def loss_fn(p, b):
        return spec.loss_fn(p, b) * b["s"].mean()

    ad = AutoDist(strategy_builder=Zero1(ZERO1_BUCKET_BYTES), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"),
                   optimizer=fusable_adam(1e-2), loss_fn=loss_fn,
                   sparse_vars=spec.sparse_vars,
                   numerics={"clip_norm": CLIP, "on_nonfinite": "rollback",
                             "rollback_after": 2})
    batch = dict(spec.sample_batch(8, seed=1), s=np.ones(8, np.float32))
    return ad.create_distributed_session(), batch


def poisoned_epoch(batch, epoch):
    """A generator factory of two copies of ``batch``; the first pass of
    ``epoch`` has ``s`` = NaN in both."""
    calls = []

    def factory():
        calls.append(1)
        s = np.full(8, np.nan if len(calls) == epoch + 1 else 1.0,
                    np.float32)
        return iter([dict(batch, s=s), dict(batch, s=s)])
    return factory


def ckpt_main(directory):
    """The ``ckpt`` mode: per run, the uninterrupted ``fit`` and the resumed
    one (``{run}/epoch_loss``, ``{run}/p/{variable}``, and the same under
    ``{run}/resumed/``)."""
    out = {}
    for name, make in ckpt_runs().items():
        ckpt_dir = os.path.join(directory, name)
        sess, batch = make()
        hist = sess.fit([batch, batch], epochs=CKPT_EPOCHS)
        out[f"{name}/epoch_loss"] = np.array(hist.history["epoch_loss"])
        out.update({f"{name}/p/{k}": v for k, v in flatten(sess.params)})
        sess, batch = make()
        sess.fit([batch, batch], epochs=1, steps_per_epoch=2,
                 checkpoint_dir=ckpt_dir)
        sess, batch = make()
        hist = sess.fit([batch, batch], epochs=CKPT_EPOCHS, steps_per_epoch=2,
                        checkpoint_dir=ckpt_dir, resume=True)
        out[f"{name}/resumed/epoch_loss"] = np.array(
            hist.history["epoch_loss"])
        out[f"{name}/resumed/step"] = np.int64(sess.step_count)
        out.update({f"{name}/resumed/p/{k}": v
                    for k, v in flatten(sess.params)})
    for poisoned in (False, True):
        sess, batch = rollback_session()
        data = poisoned_epoch(batch, 1 if poisoned else -1)
        hist = sess.fit(data, epochs=CKPT_EPOCHS, steps_per_epoch=2,
                        checkpoint_dir=os.path.join(
                            directory, f"rollback{int(poisoned)}"))
        tag = "rollback/poisoned" if poisoned else "rollback"
        out[f"{tag}/rollbacks"] = np.array(
            [(r["at_step"], r["restored_step"])
             for r in hist.history.get("rollbacks", [])]).reshape(-1, 2)
        out.update({f"{tag}/p/{k}": v for k, v in flatten(sess.params)})
    return out

# -- 1/N parameter storage ---------------------------------------------------
#: the ``storage`` mode's model (vocab by case): 2 layers at width 32
STORAGE_CFG = dict(num_layers=2, num_heads=2, head_dim=16, d_ff=64,
                   max_len=16)
#: ``{case: (builder, its arguments, vocab, environment)}``: the sparse
#: ``embed`` on PS, every variable partitioned, vocab 97 on 4 ranks (JAX
#: pads it), the hybrid, bounded staleness and a proxy plan
STORAGE_CASES = {
    "ps_lb": ("PSLoadBalancing", {}, 96, {}),
    "partitioned_ps": ("PartitionedPS", {}, 96, {}),
    "uneven_ps": ("UnevenPartitionedPS", {}, 97, {}),
    "parallax": ("Parallax", {}, 96, {}),
    "ps_stale": ("PS", {"staleness": 2}, 96, {}),
    "parallax_proxy": ("Parallax", {"local_proxy_variable": True}, 96,
                       {"AUTODIST_PROXY_REFRESH": "2"}),
}
#: the cases a checkpoint crosses rank counts with
STORAGE_CKPT_CASES = ("ps_lb", "uneven_ps")
#: the resource spec the builders of the ``storage`` mode plan for: one
#: node of 4 chips, the JAX session's too
STORAGE_SPEC = {"nodes": [{"address": "localhost", "chips": 4,
                           "chief": True}]}


def storage_session(case, params, numerics=None, loss_wrap=None):
    """The facade's session of ``case`` (:data:`STORAGE_CASES`) from
    ``params`` with ``fusable_adam(1e-2)`` and clip (``numerics``
    overrides), and its model spec."""
    import warnings

    from autodist_tpu_torch.resource_spec import ResourceSpec

    name, kwargs, vocab, env = STORAGE_CASES[case]
    _reset_default_autodist_for_testing()
    spec = transformer_lm(vocab_size=vocab, **STORAGE_CFG)
    loss_fn = spec.loss_fn if loss_wrap is None else loss_wrap(spec.loss_fn)
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)          # read when the session is built
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the stale guard's drop
            ad = AutoDist(strategy_builder=getattr(port_strategy, name)(
                **kwargs), resource_spec=ResourceSpec(
                    resource_info=STORAGE_SPEC), device="cpu")
            with ad.scope():
                ad.capture(params=unflatten([
                    (n, torch.from_numpy(np.array(x))) for n, x in
                    flatten(params)]), optimizer=fusable_adam(1e-2),
                    loss_fn=loss_fn, sparse_vars=spec.sparse_vars,
                    numerics=numerics or {"clip_norm": CLIP})
            sess = ad.create_distributed_session()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return sess, spec


def storage_state(out, prefix, sess):
    """The logical parameters and moments, and this rank's stored parts
    and their chunk facts, into ``out`` under ``prefix``."""
    params, opt = sess.export_state()
    out.update({f"{prefix}/p/{k}": v.numpy() for k, v in flatten(params)})
    if "zero1" in opt:
        out.update({f"{prefix}/o/{m}/{k}": v.numpy()
                    for m in ("mu", "nu")
                    for k, v in opt["zero1"][m].items()})
    leaves = dict(flatten(sess.device_params))
    for b in sess.stored_buckets:
        out[f"{prefix}/stored/{b.key}"] = np.array(
            [b.padded_total, sum(leaves[n].numel() for n in b.names),
             b.total])
        out.update({f"{prefix}/part/{n}": leaves[n].detach().numpy()
                    for n in b.names})
    out.update({f"{prefix}/shape/{n}": np.array(tuple(x.shape))
                for n, x in leaves.items()})
    out.update({f"{prefix}/target/{n}": np.array(tuple(x.shape))
                for n, x in flatten(sess.restore_targets()[0])})


def storage_main(data, directory):
    """The ``storage`` mode: per case of :data:`STORAGE_CASES`, 3 steps on
    ``data``'s weights and batch (``{case}/losses``, the logical state,
    the stored parts); a checkpoint of 3 steps written for a 1-rank
    restore and the test's 1-rank checkpoint restored here; a numerics
    rollback against its uninterrupted twin."""
    from autodist_tpu_torch.checkpoint import Saver

    out = {}
    for case, (_, _, vocab, _) in STORAGE_CASES.items():
        params = {k[len(f"v{vocab}/p/"):]: data[k] for k in data.files
                  if k.startswith(f"v{vocab}/p/")}
        batch = {"tokens": data[f"v{vocab}/tokens"]}
        sess, _ = storage_session(case, unflatten(list(params.items())))
        out[f"{case}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(STEPS)])
        out[f"{case}/eval"] = np.float32(sess.evaluate(batch)["loss"])
        out[f"{case}/flops"] = np.float64(sess.flops_per_step())
        storage_state(out, case, sess)
        if case in STORAGE_CKPT_CASES:
            Saver(sess).save(os.path.join(directory, f"{case}_four"))
            sess, _ = storage_session(case, unflatten(list(params.items())))
            Saver(sess).restore(os.path.join(directory, f"{case}_one",
                                             "step_2"))
            storage_state(out, f"{case}/from_one", sess)

    # the numerics rollback on the stored shards: two NaN epochs' steps
    # restore the verified-good step and replay, ending on the clean run
    params = {k[len("v96/p/"):]: data[k] for k in data.files
              if k.startswith("v96/p/")}
    batch = {"tokens": data["v96/tokens"]}

    def scaled(loss_fn):
        return lambda p, b: loss_fn(p, b) * b["s"].mean()
    for poisoned in (False, True):
        sess, _ = storage_session(
            "ps_lb", unflatten(list(params.items())),
            numerics={"clip_norm": CLIP, "on_nonfinite": "rollback",
                      "rollback_after": 2}, loss_wrap=scaled)
        hist = sess.fit(poisoned_epoch(batch, 1 if poisoned else -1),
                        epochs=CKPT_EPOCHS, steps_per_epoch=2,
                        checkpoint_dir=os.path.join(
                            directory, f"rollback{int(poisoned)}"))
        tag = "rollback/poisoned" if poisoned else "rollback"
        out[f"{tag}/rollbacks"] = np.array(
            [(r["at_step"], r["restored_step"])
             for r in hist.history.get("rollbacks", [])]).reshape(-1, 2)
        storage_state(out, tag, sess)
    return out


# -- P6: compressors, fused groups, the pipeline, hier, staleness ------------
#: the compressors of the ``p6`` mode's sessions on :func:`lin_problem`
P6_COMPRESSORS = ("NoneCompressor", "HorovodCompressor",
                  "HorovodCompressorEF", "PowerSGDCompressor")
#: the resource spec of the 4-rank ``hier`` runs: 2 slices of 2
HIER_SPEC = {"nodes": [{"address": "localhost", "chips": 4}],
             "num_slices": 2}
#: the pipeline runs on the LM: (name, builder, accum, rows of the batch
#: per rank): 4 rows make 2 even microbatches, 5 an uneven tail
PIPE_RUNS = (
    ("zero1_pipe", lambda: Zero1(overlap="pipeline"), 2, 4),
    ("zero1_none", lambda: Zero1(overlap="none"), 2, 4),
    ("ar_pipe", lambda: AllReduce(bucket_bytes=1 << 20, overlap="pipeline"),
     2, 4),
    ("zero1_pipe_uneven", lambda: Zero1(overlap="pipeline"), 2, 5),
    ("zero1_none_uneven", lambda: Zero1(overlap="none"), 2, 5),
)
#: the quantized pipelined runs (the ring at 256 KiB under "full")
QPIPE_RUNS = (
    ("int8_pipeline", lambda: Zero1(QUANT_BUCKET_BYTES,
                                    compressor="Int8Compressor",
                                    overlap="pipeline")),
    ("int8_full", lambda: Zero1(QUANT_BUCKET_BYTES,
                                compressor="Int8Compressor",
                                overlap="full")),
)
#: the staleness runs: (name, builder kwargs, refresh period, steps)
STALE_RUNS = (("s1", {"staleness": 1}, 1, 10),
              ("s2", {"staleness": 2}, 1, 10),
              ("s4", {"staleness": 4}, 1, 10),
              ("warm3", {"staleness": 3}, 1, 3),
              ("proxy_r2", {"local_proxy_variable": True}, 2, 8),
              ("proxy_r1", {"local_proxy_variable": True}, 1, 6),
              ("both", {"staleness": 2, "local_proxy_variable": True}, 2,
               10))


def lin_problem():
    """``tests/test_compressors.py``'s least squares: ``(params, loss,
    batch)`` as numpy."""
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    true_w = rng.randn(8, 4).astype(np.float32)
    params = {"linear": {"w": np.zeros((8, 4), np.float32),
                         "b": np.zeros((4,), np.float32)}}

    def loss(p, b):
        return ((b["x"] @ p["linear"]["w"] + p["linear"]["b"]
                 - b["y"]) ** 2).mean()
    return params, loss, {"x": x, "y": (x @ true_w).astype(np.float32)}


def prog_e_problem(n):
    """Program E of the JAX multichip dry run (``__graft_entry__.py:
    243-266``) at ``n`` ranks: ``(params, loss, batch)``."""
    rng = np.random.RandomState(3)
    batch = {"x": rng.randn(4 * n, 8).astype(np.float32),
             "y": rng.randn(4 * n, 4).astype(np.float32)}
    params = {"w1": (rng.randn(8, 16) * 0.2).astype(np.float32),
              "w2": (rng.randn(16, 4) * 0.2).astype(np.float32),
              "b": np.zeros((4,), np.float32)}

    def loss(p, b):
        h = (b["x"] @ p["w1"]).tanh() if isinstance(b["x"], torch.Tensor) \
            else np.tanh(b["x"] @ p["w1"])
        return ((h @ p["w2"] + p["b"] - b["y"]) ** 2).mean()
    return params, loss, batch


def hier_problem():
    """``tests/test_hier_sync.py``'s problem: ``(params, loss, batch)``."""
    rng = np.random.RandomState(3)
    params = {"a": {"w": (rng.randn(13, 9) * 0.1).astype(np.float32),
                    "b": (rng.randn(9) * 0.1).astype(np.float32)},
              "out": {"w": (rng.randn(9, 4) * 0.1).astype(np.float32)}}
    batch = {"x": rng.randn(16, 13).astype(np.float32),
             "y": rng.randn(16, 4).astype(np.float32)}

    def loss(p, b):
        h = torch.tanh(b["x"] @ p["a"]["w"] + p["a"]["b"])
        return ((h @ p["out"]["w"] - b["y"]) ** 2).mean()
    return params, loss, batch


def stale_problem(steps):
    """``tests/test_stale_sync.py``'s problem and batches: ``(params, loss,
    batches)``."""
    params = {"w": np.zeros((4, 1), np.float32)}
    rng = np.random.RandomState(3)
    batches = [{"x": rng.randn(16, 4).astype(np.float32),
                "y": rng.randn(16, 1).astype(np.float32)}
               for _ in range(steps)]

    def loss(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()
    return params, loss, batches


def p6_inputs(n, seed=5):
    """The compressor units' rows: ``{"g": [n, 6, 5], "s": [n, 6, 5],
    "v": [n, 40]}`` f32 (a gradient, an EF residual and a flat bucket per
    rank)."""
    rng = np.random.RandomState(seed)
    return {"g": rng.randn(n, 6, 5).astype(np.float32),
            "s": (rng.randn(n, 6, 5) * 1e-3).astype(np.float32),
            "v": rng.randn(n, 40).astype(np.float32)}


def facade(builder, params, loss, opt, accum=1, spec=None):
    """A facade session of ``loss`` from numpy ``params``."""
    import warnings

    from autodist_tpu_torch.resource_spec import ResourceSpec

    _reset_default_autodist_for_testing()
    ad = AutoDist(strategy_builder=builder, device="cpu",
                  resource_spec=ResourceSpec(resource_info=spec)
                  if spec else None)
    with ad.scope():
        ad.capture(params=unflatten([(k, torch.from_numpy(np.array(v)))
                                     for k, v in flatten(params)]),
                   optimizer=opt, loss_fn=loss, accum_steps=accum)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return ad.create_distributed_session()


def _params_out(out, prefix, sess):
    out.update({f"{prefix}/p/{k}": v for k, v in flatten(sess.params)})


def p6_main(inputs):
    """The ``p6`` mode: ``{key: array}`` of every run (see the module
    docstring)."""
    from autodist_tpu_torch.kernel.synchronization.compressor import \
        get_compressor

    rank, n = dist.get_rank(), dist.get_world_size()
    group = dist.group.WORLD
    out = {}
    # the compressor units
    g, st, v = (torch.from_numpy(inputs[k][rank]) for k in ("g", "s", "v"))
    for name in ("HorovodCompressor", "HorovodCompressorEF"):
        comp = get_compressor(name)
        state = st if name.endswith("EF") else None
        red, new = comp.reduce(g, state, group, n)
        out[f"unit/{name}/reduce"] = red.numpy()
        shard, new2 = comp.reduce_scatter(v, None if state is None
                                          else v * 1e-3, group, n)
        out[f"unit/{name}/rs"] = shard.numpy()
        if state is not None:
            out[f"unit/{name}/state"] = new.numpy()
            out[f"unit/{name}/rs_state"] = new2.numpy()
    comp = get_compressor("PowerSGDCompressor")
    q = torch.from_numpy(inputs["q"])
    red, new = comp.reduce(g, {"q": q, "residual": st}, group, n)
    out["unit/PowerSGD/reduce"] = red.numpy()
    out["unit/PowerSGD/q"] = new["q"].numpy()
    out["unit/PowerSGD/residual"] = new["residual"].numpy()

    # sessions on the least squares
    params, loss, batch = lin_problem()
    for name in P6_COMPRESSORS:
        for steps in (5, 60):
            sess = facade(AllReduce(compressor=name), params, loss,
                          optim.sgd(0.1))
            if name == "PowerSGDCompressor":
                sess.import_state(sess.params, sess.opt_state,
                                  sync_state=inputs["psgd"][rank])
            out[f"comp/{name}/{steps}"] = np.array(
                [float(sess.run(batch)["loss"]) for _ in range(steps)])
            if steps == 5:
                _params_out(out, f"comp/{name}", sess)

    # Program E and fused groups
    params, loss, batch = prog_e_problem(n)
    for tag, builder, accum in (
            ("e_comp", AllReduce(compressor="HorovodCompressorEF",
                                 fused_groups=True, chunk_size=2), 2),
            ("e_ref", AllReduce(), 2),
            ("fused", AllReduce(chunk_size=2, fused_groups=True), 1),
            ("plain", AllReduce(chunk_size=2), 1)):
        sess = facade(builder, params, loss, optim.sgd(0.1), accum=accum)
        out[f"{tag}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(5)])
        out[f"{tag}/buckets"] = np.array(
            sorted(b.key for b in sess._step.buckets))
        out[f"{tag}/sync"] = np.array(sorted(sess.sync_state))
        _params_out(out, tag, sess)

    # bounded staleness and proxies
    for tag, kw, refresh, steps in STALE_RUNS:
        os.environ["AUTODIST_PROXY_REFRESH"] = str(refresh)
        params, loss, batches = stale_problem(steps)
        sess = facade(PS(**kw), params, loss, optim.sgd(0.1))
        for b in batches:
            sess.run(b)
        out[f"stale/{tag}/w"] = sess.params["w"]
    os.environ.pop("AUTODIST_PROXY_REFRESH", None)

    # the accumulation pipeline on the LM
    for tag, make, accum, rows in PIPE_RUNS:
        sess, batch = lm_session(make(), accum=accum, rows=rows * n)
        out[f"pipe/{tag}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(3)])
        _params_out(out, f"pipe/{tag}", sess)
    for tag, make in QPIPE_RUNS:
        sess, batch = lm_session(make(), opt=fusable_adam(QUANT_LR),
                                 accum=2, cfg=QUANT_CFG,
                                 numerics={"clip_norm": CLIP})
        res = [sess.run(batch) for _ in range(3)]
        out[f"qpipe/{tag}/losses"] = np.array([float(r["loss"])
                                               for r in res])
        out[f"qpipe/{tag}/algs"] = np.array(sorted(
            f"{k}={a}" for k, a in sess._step.bucket_algs.items()))
        _params_out(out, f"qpipe/{tag}", sess)

    if n == 4:
        out.update(p6_hier_main())
    return out


def p6_hier_main():
    """The 4-rank ``hier`` runs: flat and two-tier ``AllReduce`` and
    ``Zero1`` on :func:`hier_problem`, f32 and with the int8 DCN wire, and
    a two-tier ZeRO-1 checkpoint restored flat and back."""
    import tempfile

    from autodist_tpu_torch.checkpoint import Saver

    out = {}
    params, loss, batch = hier_problem()
    for wire in ("f32", "int8"):
        if wire == "int8":
            os.environ["AUTODIST_DCN_WIRE"] = "int8"
        for tag, make in (("ar", lambda h: AllReduce(bucket_bytes=1 << 20,
                                                     hier=h)),
                          ("zero1", lambda h: Zero1(hier=h))):
            for hier in (False, True):
                sess = facade(make(hier), params, loss, optim.adam(1e-2),
                              spec=HIER_SPEC)
                key = f"hier/{wire}/{tag}/{'hier' if hier else 'flat'}"
                out[f"{key}/losses"] = np.array(
                    [float(sess.run(batch)["loss"]) for _ in range(5)])
                out[f"{key}/hier_keys"] = np.array(
                    len(sess._step.hier_keys))
                _params_out(out, key, sess)
        os.environ.pop("AUTODIST_DCN_WIRE", None)
    # a hier checkpoint restored flat, a flat one restored hier
    directory = tempfile.mkdtemp() if dist.get_rank() == 0 else None
    holder = [directory]
    dist.broadcast_object_list(holder)
    for src, dst in ((True, False), (False, True)):
        a = facade(Zero1(hier=src), params, loss, optim.adam(1e-2),
                   spec=HIER_SPEC)
        for _ in range(2):
            a.run(batch)
        path = Saver(a).save(os.path.join(holder[0], f"h{int(src)}"))
        b = facade(Zero1(hier=dst), params, loss, optim.adam(1e-2),
                   spec=HIER_SPEC)
        Saver(b).restore(path)
        tag = f"hier_ckpt/{int(src)}to{int(dst)}"
        (pa, oa), (pb, ob) = a.export_state(), b.export_state()
        out[f"{tag}/same"] = np.array(all(
            torch.equal(x, y) for (_, x), (_, y) in
            zip(flatten({"p": pa, "o": oa}), flatten({"p": pb, "o": ob}))))
        out[f"{tag}/next"] = np.array([float(a.run(batch)["loss"]),
                                       float(b.run(batch)["loss"])])
    return out



def telemetry_main(directory):
    """The ``telemetry`` mode: what the JAX package's session telemetry
    tests check, on this rank (``directory`` holds the run directory and
    the trace windows)."""
    import json

    from autodist_tpu_torch.telemetry import LegProfiler, load_step_records
    from autodist_tpu_torch.utils import tracing

    rank = dist.get_rank()
    out = {}
    run_dir = os.path.join(directory, "telemetry")
    # records flush to the env directory, one file per rank
    os.environ["AUTODIST_TELEMETRY_DIR"] = run_dir
    sess, batch = session("zero1")
    on = [float(sess.run(batch, sync=False)["loss"]) for _ in range(STEPS)]
    sess.telemetry.flush()
    out["on_losses"] = np.array(on)
    out["record_steps"] = np.array([r.step for r in sess.telemetry.records])
    out["record_items"] = np.array(
        [r.items_per_s is not None for r in sess.telemetry.records])
    out["dispatch"] = np.array(
        [r.phases.get("dispatch", 0.0) > 0 for r in sess.telemetry.records])
    out["directory"] = np.array(sess.telemetry.directory)
    dist.barrier()
    out["loaded"] = np.array(len(load_step_records(run_dir)))
    # fit adds data_load, blocking_fetch and the loss, and its goodput
    hist = sess.fit([batch] * 4, epochs=1, log_every=2)
    recs = sess.telemetry.records[-4:]
    out["fit_data_load"] = np.array(["data_load" in r.phases for r in recs])
    out["fit_loss"] = np.array([r.loss is not None for r in recs])
    out["fit_health"] = np.array([r.all_finite is not None for r in recs])
    out["goodput"] = np.array(json.dumps(hist.goodput))
    # the same steps with telemetry off: the same losses, bit for bit
    os.environ["AUTODIST_TELEMETRY"] = "0"
    os.environ.pop("AUTODIST_TELEMETRY_DIR")
    sess, batch = session("zero1")
    out["off_losses"] = np.array(
        [float(sess.run(batch, sync=False)["loss"]) for _ in range(STEPS)])
    out["off_recorder"] = np.array(sess.telemetry is None)
    os.environ.pop("AUTODIST_TELEMETRY")
    # windows opened mid-run at steps 2 and 4, one step each
    os.environ["AUTODIST_TRACE_STEPS"] = "1"
    os.environ["AUTODIST_TRACE_AT"] = "2,4"
    tracing.DEFAULT_TRACE_DIR = os.path.join(directory, f"traces{rank}")
    sess, batch = session("zero1")
    for _ in range(6):
        sess.run(batch)
    tracing.flush_active_trace()
    out["trace_paths"] = np.array(
        [os.path.relpath(p, directory) for p in sess.tracer.paths])
    kinds = {}
    for path in sess.tracer.paths:
        for sample in LegProfiler().parse_trace(os.path.dirname(path)):
            kinds[sample.kind] = kinds.get(sample.kind, 0) + 1
    out["trace_kinds"] = np.array(json.dumps(kinds, sort_keys=True))
    return out


def span_runs():
    """``{name: () -> (session, batch)}`` of the ``spans`` mode: every
    sync leg the bucketed step names, at 4 ranks."""
    hier = hier_problem()
    return {
        "allreduce": lambda: lm_session(AllReduce(bucket_bytes=1 << 12),
                                        numerics={"clip_norm": CLIP}),
        "zero1": lambda: session("zero1"),
        "PSLoadBalancing": lambda: session("PSLoadBalancing"),
        "int8_ring": lambda: quant_session("int8_allreduce"),
        "fp8_ring_zero1": lambda: quant_session("fp8_zero1"),
        "horovod": lambda: lm_session(AllReduce(
            compressor="HorovodCompressor")),
        "powersgd": lambda: lm_session(AllReduce(
            compressor="PowerSGDCompressor")),
        "hier_zero1": lambda: (facade(Zero1(hier=True), hier[0], hier[1],
                                      optim.adam(1e-2), spec=HIER_SPEC),
                               hier[2]),
        "hier_allreduce": lambda: (facade(
            AllReduce(bucket_bytes=1 << 20, hier=True), hier[0], hier[1],
            optim.adam(1e-2), spec=HIER_SPEC), hier[2]),
        "pipeline": lambda: lm_session(
            Zero1(ZERO1_BUCKET_BYTES, overlap="pipeline"),
            opt=fusable_adam(1e-2), accum=2, numerics={"clip_norm": CLIP}),
        "pipeline_int8": lambda: lm_session(
            Zero1(ZERO1_BUCKET_BYTES, compressor="Int8Compressor",
                  overlap="pipeline"), opt=fusable_adam(1e-2), accum=2),
    }


def spans_main(directory):
    """The ``spans`` mode: one warm-up step and one step under a CPU
    ``torch.profiler`` of each of :func:`span_runs`; per run, the
    ``autodist_sync/`` range names this rank recorded, how many, and the
    samples ``LegProfiler.parse_trace`` gives from the exported trace."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from autodist_tpu_torch.telemetry import LegProfiler
    from autodist_tpu_torch.telemetry.profiler import (SYNC_SCOPE_PREFIX,
                                                       span_leg_kind)

    rank = dist.get_rank()
    out = {}
    for name, make in span_runs().items():
        sess, batch = make()
        sess.run(batch)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sess.run(batch)
        trace_dir = os.path.join(directory, name, f"rank{rank}")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "run.trace.json"))
        names = [e.name for e in prof.events()
                 if e.name.startswith(SYNC_SCOPE_PREFIX)]
        samples = LegProfiler().parse_trace(trace_dir)
        out[f"{name}/names"] = np.array(json.dumps(sorted(set(names))))
        out[f"{name}/ranges"] = np.array(
            sum(span_leg_kind(n) is not None for n in names))
        out[f"{name}/samples"] = np.array(len(samples))
    return out


def auto_main(data):
    """The ``auto`` mode (see the module docstring)."""
    from autodist_tpu_torch.convert import params_from_jax
    from autodist_tpu_torch.resource_spec import ResourceSpec

    params = unflatten([(k[2:], data[k]) for k in data.files
                        if k.startswith("p:")])
    batch = {k[2:]: data[k] for k in data.files if k.startswith("b:")}
    _reset_default_autodist_for_testing()
    if dist.get_rank() != 0:
        import functools

        from autodist_tpu_torch.strategy import search
        search.SearchSpace = functools.partial(
            search.SearchSpace, max_evals=1)
    spec = transformer_lm(**CFG)
    builder = port_strategy.AutoStrategy(search="beam")
    ad = AutoDist(resource_spec=ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "chips": 4}]}),
        strategy_builder=builder, device="cpu")
    with ad.scope():
        ad.capture(params=params_from_jax(params),
                   optimizer=fusable_adam(1e-3), loss_fn=spec.loss_fn,
                   sparse_vars=spec.sparse_vars, numerics={"clip_norm": CLIP})
    sess = ad.create_distributed_session(validate=True)
    losses = [float(sess.run(batch)["loss"]) for _ in range(STEPS)]
    return {"losses": np.array(losses), "choice": builder.last_choice,
            "strategy_id": ad._strategy.id,
            "fingerprint": sess.schedule_fingerprint,
            **{f"p:{k}": v for k, v in flatten(sess.params)}}


def tune_main():
    """The ``tune`` mode: the ScheduleTuner on every rank (see
    ``tests/test_torch_tuner.py``).  Rank 0 alone is fed the drifted
    samples (the others on-model ones): its decision is the world's."""
    from autodist_tpu_torch.autodist import get_default_autodist
    from autodist_tpu_torch.checkpoint.tiers import (capture_snapshot,
                                                     load_snapshot)
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import ScheduleTuner
    from autodist_tpu_torch.strategy.search import SearchSpace
    from autodist_tpu_torch.telemetry.calibration import (LEG_KINDS,
                                                          LegCalibration)

    rank = dist.get_rank()
    active = LegCalibration()
    for kind in LEG_KINDS:
        active.bandwidths[kind], active.alphas[kind] = 45e9, 5e-6
    active.quant_overhead_per_byte = 0.0
    samples = []
    for nb in (1 << 18, 1 << 20, 4 << 20):
        for kind in ("all_reduce", "reduce_scatter", "all_gather",
                     "ps_exchange", "ppermute_hop", "update", "psum_guard"):
            slow = 20 if kind == "all_reduce" and rank == 0 else 1
            samples += [{"kind": kind, "measured_s": slow * nb / 45e9 + 5e-6,
                         "nbytes": nb} for _ in range(6)]
    rs = ResourceSpec(resource_info={
        "nodes": [{"address": "localhost", "chips": dist.get_world_size()}]})

    sess, batch = session("allreduce")
    gi = get_default_autodist().graph_item
    old_fp = sess.schedule_fingerprint
    for _ in range(STEPS):
        sess.run(batch)
    anchor = capture_snapshot(sess)
    tuner = ScheduleTuner(gi, rs, constants=active,
                          space=SearchSpace(max_rounds=1),
                          calibration_path=None)
    tuner.feed_samples(samples)
    swapped = tuner.maybe_retune(sess)
    out = {"swapped": swapped, "searched": tuner.last_result is not None,
           "moments_exact": tuner.last_swap_exact_opt,
           "old_fp": old_fp, "new_fp": sess.schedule_fingerprint,
           "step_after_swap": sess.step_count}
    out["losses"] = np.array([float(sess.run(batch)["loss"])
                              for _ in range(STEPS)])
    params = dict(flatten(sess.params))
    out.update({f"p:{k}": v for k, v in params.items()})
    strategy = sess._step.compiled_strategy.strategy

    # a rank-local decision: rank 1 asks for another strategy
    local = strategy if rank != 1 else port_strategy.AllReduce().build(
        gi, rs)
    try:
        tuner.hot_swap(sess, local)
        out["local_decision_raised"] = False
    except RuntimeError:
        out["local_decision_raised"] = True
    out["fp_after_local"] = sess.schedule_fingerprint
    del sess

    class Fixed:
        def build(self, graph_item, resource_spec):
            return strategy

    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)
    ad = AutoDist(strategy_builder=Fixed(), device="cpu")
    with ad.scope():
        ad.capture(params=spec.init(0, device="cpu"), optimizer=optim.adam(
            1e-2), loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    oracle = ad.create_distributed_session()
    tuner.adopt_snapshot(oracle, anchor, oracle._step)
    out["oracle_losses"] = np.array([float(oracle.run(batch)["loss"])
                                     for _ in range(STEPS)])
    got = dict(flatten(oracle.params))
    out["oracle_params_equal"] = all(np.array_equal(got[n], v)
                                     for n, v in params.items())
    del oracle

    # a 1/N-stored session's snapshot restores exactly
    ps, batch = session("PSLoadBalancing")
    out["stored"] = bool(ps.stored_buckets)
    for _ in range(2):
        ps.run(batch)
    snap = capture_snapshot(ps)
    first = [float(ps.run(batch)["loss"]) for _ in range(2)]
    load_snapshot(ps, snap)
    out["stored_resume_exact"] = first == [float(ps.run(batch)["loss"])
                                           for _ in range(2)]
    return out


def session(strategy="allreduce", device="cpu"):
    """The facade's session for ``strategy`` in this process, and the
    model's fixed global batch: ``"allreduce"`` (``adam``), ``"zero1"``,
    or the name of a builder of :data:`PS_LM_BUILDERS` (``fusable_adam``
    and the guard with clip)."""
    torch.manual_seed(0)
    _reset_default_autodist_for_testing()
    spec = transformer_lm(**CFG)
    if strategy == "allreduce":
        builder, opt, numerics = AllReduce(), optim.adam(1e-2), None
    else:
        builder = Zero1(ZERO1_BUCKET_BYTES) if strategy == "zero1" \
            else getattr(port_strategy, strategy)()
        opt, numerics = fusable_adam(1e-2), {"clip_norm": CLIP}
    ad = AutoDist(strategy_builder=builder, device=device)
    with ad.scope():
        ad.capture(params=spec.init(0, device=device), optimizer=opt,
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars,
                   numerics=numerics)
    return ad.create_distributed_session(), spec.sample_batch(8, seed=1)


def train(strategy="allreduce", device="cpu"):
    """Losses, final parameters and the session of the facade run."""
    sess, batch = session(strategy, device)
    losses = [float(sess.run(batch)["loss"]) for _ in range(STEPS)]
    return losses, dict(flatten(sess.params)), sess


def _quant_steps(out, prefix, sess, batch, steps=3):
    """``steps`` steps of ``sess``: losses, finiteness and saturation
    counts per step, then the parameters, this rank's residuals and the
    lowerings, into ``out`` under ``prefix``."""
    for step in range(steps):
        m = sess.run(batch)
        h = m["grad_health"]
        out[f"{prefix}/loss/{step}"] = np.float32(m["loss"])
        out[f"{prefix}/finite/{step}"] = np.bool_(h.all_finite)
        for key, entry in h.per_bucket.items():
            out[f"{prefix}/sat/{step}/{key}"] = entry["sat_count"]
    out.update({f"{prefix}/p/{k}": v for k, v in flatten(sess.params)})
    out.update({f"{prefix}/residual/{k}": v.numpy()
                for k, v in sess.sync_state.items()
                if isinstance(v, torch.Tensor)})
    out[f"{prefix}/algs"] = np.array(sorted(
        f"{k}={a}" for k, a in sess._step.bucket_algs.items()))


def quant_main(states):
    """The ``quant`` mode, per run: 3 steps from the init (under the run's
    name); one step from each state of ``states[name]``, this rank's share
    of the JAX session's state after k steps, keyed by k (under
    ``from{k}/{name}``); 3 steps on the linear loss (under
    ``linear/{name}``)."""
    out = {}
    for name in quant_runs():
        _quant_steps(out, name, *quant_session(name))
        _quant_steps(out, f"linear/{name}",
                     *quant_session(name, linear=True))
        sess, batch = quant_session(name)
        for k, state in states[name].items():
            sess.import_state(state["params"], state["opt_state"], step=k,
                              sync_state=state["sync_state"])
            _quant_steps(out, f"from{k}/{name}", sess, batch, steps=1)
    return out


def main():
    rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    strategy = sys.argv[5] if len(sys.argv) > 5 else "allreduce"
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, world, rank)
    try:
        if strategy == "ring":
            data = np.load(sys.argv[6])
            rows = {k: torch.from_numpy(data[k][rank]) for k in
                    ("x", "grid_int8", "grid_fp8", "state")}
            np.savez(out, **ring_functions(
                rows["x"], rows["grid_int8"], rows["grid_fp8"],
                rows["state"], dist.group.WORLD, world))
            return
        if strategy == "ps":
            np.savez(out, **ps_main(np.load(sys.argv[6])))
            return
        if strategy == "ps_model":
            np.savez(out, **ps_model_main(np.load(sys.argv[6])))
            return
        if strategy == "models":
            np.savez(out, **models_main(np.load(sys.argv[6])))
            return
        if strategy == "levers":
            np.savez(out, **levers_main(np.load(sys.argv[6])))
            return
        if strategy == "p6":
            np.savez(out, **p6_main(torch.load(sys.argv[6],
                                               weights_only=False)))
            return
        if strategy == "ckpt":
            np.savez(out, **ckpt_main(sys.argv[6]))
            return
        if strategy == "storage":
            np.savez(out, **storage_main(np.load(sys.argv[6]), sys.argv[7]))
            return
        if strategy == "quant":
            np.savez(out, **quant_main(torch.load(
                sys.argv[6].format(rank=rank))))
            return
        if strategy == "telemetry":
            np.savez(out, **telemetry_main(sys.argv[6]))
            return
        if strategy == "spans":
            np.savez(out, **spans_main(sys.argv[6]))
            return
        if strategy == "auto":
            np.savez(out, **auto_main(np.load(sys.argv[6])))
            return
        if strategy == "tune":
            np.savez(out, **tune_main())
            return
        sess, batch = session(strategy)
        results = [sess.run(batch) for _ in range(STEPS)]
        data_axis, buckets = sess.data_axis_size, len(sess._step.buckets)
        trained = {f"p:{k}": v for k, v in flatten(sess.params)}
        extra = {}
        if strategy == "zero1":
            _, exported = sess.export_state()
            z = sess.opt_state["zero1"]
            extra = {"norms": np.array([float(r["grad_health"].global_norm)
                                        for r in results]),
                     **{f"shard:{k}": v.numel() for k, v in z["mu"].items()},
                     **{f"full_{m}:{k}": v.numpy()
                        for m in ("mu", "nu")
                        for k, v in exported["zero1"][m].items()}}
            if len(sys.argv) > 6:
                state = torch.load(sys.argv[6])[rank]
                sess, batch = session(strategy)
                sess.import_state(state["params"], state["opt_state"],
                                  step=state["step"],
                                  sync_state=state["sync_state"])
                extra["resumed"] = np.array(
                    [float(sess.run(batch)["loss"]) for _ in range(2)])
                extra.update({f"rp:{k}": v for k, v in
                              flatten(sess.params)})
        np.savez(out, losses=np.array([float(r["loss"]) for r in results]),
                 data_axis=data_axis, buckets=buckets, **trained, **extra)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
