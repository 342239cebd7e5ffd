"""One rank of the port's resilience drills on gloo CPU ranks (spawned by
``tests/test_torch_elastic.py`` and ``tests/test_torch_chaos_numerics.py``).

    python tests/torch_resilience_worker.py RANK WORLD INIT OUT.npz MODE DIR

(started by ``tests/torch_launch.py`` or by a :class:`~autodist_tpu_torch.
resilience.Supervisor`'s launch callable; ``INIT`` is the group's init
method, a ``file://`` store).

``donor`` trains every case of :data:`ELASTIC_CASES` for :data:`STEPS`
steps, saves a Saver checkpoint under ``DIR/<case>`` (rank 0 writes)
and a RAM snapshot's peer wire bytes as ``DIR/<case>.snap``, writes the
logical state ``export_state`` gives (``<case>/p/<name>``,
``<case>/mu/<bucket>``, ``<case>/nu/<bucket>``) and the bucket layout,
then the losses of :data:`STEPS` more steps (``<case>/losses``): the
donor of an elastic resume.  ``resume`` builds each case's session at
this world size, runs ``elastic_restore`` on the donor's checkpoint, and
writes the same state and the next losses (:func:`resume_case`).

``supervised`` is one attempt of a supervised job: ``fit`` over
:data:`FIT_EPOCHS` epochs of 2 steps with a checkpoint after each epoch
under ``DIR`` (resuming the newest), :class:`~autodist_tpu_torch.
resilience.ChaosCallback` on ``AUTODIST_CHAOS``, and the final
parameter digest and step (only when the attempt finishes).

Each rank runs one intra-op thread.
"""
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch  # noqa: E402
from torch_dp_worker import CLIP, ZERO1_BUCKET_BYTES  # noqa: E402

from autodist_tpu_torch import strategy as port_strategy  # noqa: E402
from autodist_tpu_torch.autodist import (  # noqa: E402
    AutoDist, _reset_default_autodist_for_testing)
from autodist_tpu_torch.checkpoint import Saver  # noqa: E402
from autodist_tpu_torch.checkpoint.saver import tree_digest  # noqa: E402
from autodist_tpu_torch.checkpoint.tiers import (  # noqa: E402
    capture_snapshot, snapshot_to_bytes)
from autodist_tpu_torch.graph_item import flatten  # noqa: E402
from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.ops.fused_kernels import fusable_adam  # noqa: E402

STEPS = 3
#: the drills' model: a width of 15 makes most bucket totals odd, so each
#: resize re-pads them (the reshard path, not a plain restore)
ELASTIC_CFG = dict(num_layers=2, num_heads=3, head_dim=5, d_ff=33,
                   max_len=16)
#: ``{case: (builder name, vocab)}``: ZeRO-1, and the facade's default
#: (``embed`` stored 1/N) at a vocab whose table divides 4 and at 97
ELASTIC_CASES = {"zero1": ("Zero1", 97), "ps_lb": ("PSLoadBalancing", 96),
                 "ps_lb97": ("PSLoadBalancing", 97)}
FIT_EPOCHS = 3


def elastic_session(case):
    """The facade's session of ``case`` at this process's world size
    (``fusable_adam(1e-2)``, the guard with clip), and its batch."""
    name, vocab = ELASTIC_CASES[case]
    torch.manual_seed(0)
    _reset_default_autodist_for_testing()
    spec = transformer_lm(vocab_size=vocab, **ELASTIC_CFG)
    builder = port_strategy.Zero1(ZERO1_BUCKET_BYTES) if name == "Zero1" \
        else getattr(port_strategy, name)()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ad = AutoDist(strategy_builder=builder, device="cpu")
        with ad.scope():
            ad.capture(params=spec.init(0, device="cpu"),
                       optimizer=fusable_adam(1e-2), loss_fn=spec.loss_fn,
                       sparse_vars=spec.sparse_vars,
                       numerics={"clip_norm": CLIP})
        sess = ad.create_distributed_session()
    return sess, spec.sample_batch(8, seed=1)


def logical_state(out, prefix, sess):
    """The logical parameters and ZeRO-1 moments (every rank gathers) and
    the bucket layout, into ``out`` under ``prefix``."""
    params, opt = sess.export_state()
    out.update({f"{prefix}/p/{k}": v.numpy() for k, v in flatten(params)})
    for m in ("mu", "nu"):
        out.update({f"{prefix}/{m}/{k}": v.numpy()
                    for k, v in opt["zero1"][m].items()})
    out[f"{prefix}/layout"] = np.array(
        [(b.total, b.padded_total, int(b.stored))
         for b in sess.zero1_buckets])
    out[f"{prefix}/keys"] = np.array([b.key for b in sess.zero1_buckets])


def donor_main(directory):
    out = {}
    for case in ELASTIC_CASES:
        sess, batch = elastic_session(case)
        for _ in range(STEPS):
            sess.run(batch)
        Saver(sess).save(os.path.join(directory, case))
        snap = capture_snapshot(sess)
        if sess.mesh.data_rank == 0:
            with open(os.path.join(directory, f"{case}.snap"), "wb") as f:
                f.write(snapshot_to_bytes(snap))
        logical_state(out, case, sess)
        out[f"{case}/losses"] = np.array(
            [float(sess.run(batch)["loss"]) for _ in range(STEPS)])
    return out


def resume_case(out, case, path):
    """Elastic-restore ``path`` into a fresh session of ``case`` at this
    world size; its logical state and the next :data:`STEPS` losses."""
    from autodist_tpu_torch.resilience import elastic_restore

    sess, batch = elastic_session(case)
    out[f"{case}/restored_step"] = np.int64(elastic_restore(sess, path))
    logical_state(out, case, sess)
    out[f"{case}/losses"] = np.array(
        [float(sess.run(batch)["loss"]) for _ in range(STEPS)])


def resume_main(directory):
    out = {}
    for case in ELASTIC_CASES:
        resume_case(out, case, os.path.join(directory, case,
                                            f"step_{STEPS}"))
    return out


def supervised_main(directory):
    """One attempt of the supervised job (see the module docstring)."""
    from autodist_tpu_torch.resilience import ChaosCallback, ChaosMonkey

    sess, batch = elastic_session("zero1")
    batches = [batch, {k: v[::-1].copy() for k, v in batch.items()}]
    sess.fit(batches, epochs=FIT_EPOCHS, steps_per_epoch=2,
             checkpoint_dir=directory,
             callbacks=[ChaosCallback(ChaosMonkey.from_env())])
    return {"digest": np.array(tree_digest(sess.params)),
            "step": np.int64(sess.step_count)}


def main():
    rank, world, init, out, mode, directory = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5], sys.argv[6])
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, world, rank)
    try:
        fn = {"donor": donor_main, "resume": resume_main,
              "supervised": supervised_main}[mode]
        np.savez(out, **fn(directory))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    # the rank's results are written: skip the interpreter's teardown,
    # where gloo's threads can abort a finished rank ("terminate called
    # without an active exception")
    os._exit(0)


if __name__ == "__main__":
    main()
