"""One rank of one stage group of an MPMD pipeline job on gloo CPU ranks
(spawned by ``tests/test_torch_mpmd.py``).

    python tests/torch_mpmd_worker.py STAGE RANK INIT WORKDIR MODE

Each stage group is its own ``torch.distributed`` world of :data:`DP`
ranks (``INIT`` is that group's ``file://`` store); the groups share
nothing but the activation directories under ``WORKDIR``.  The model is
the JAX drill's (``tests/integration/mpmd_train.py``): :data:`L` tanh
layers of width :data:`D`, :data:`S` stages, :data:`M` microbatches, a
global batch of :data:`B` rows, SGD at :data:`LR`.

``MODE`` ``clean`` runs one job per entry of :data:`JOBS` (ZeRO-1 off,
then on) in this world; ``chaos`` runs the ``zero1`` job with
per-step snapshots under ``WORKDIR/chaos/state`` (a supervisor relaunches
a killed group; ``AUTODIST_CHAOS`` and ``AUTODIST_ATTEMPT`` come from
it).  Each job appends one JSON line per step to
``WORKDIR/<job>/steps.s<stage>r<rank>`` and a final line with the
parameters' checksum and digest.

Each rank runs one intra-op thread.
"""
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_launch  # noqa: E402

from autodist_tpu_torch.kernel.synchronization import \
    schedule_ir as sir  # noqa: E402
from autodist_tpu_torch.parallel import mpmd  # noqa: E402

S, DP = 2, 2                 # stages x data-parallel ranks per stage
L, D = 4, 8                  # layers, width
M = 4                        # microbatches
B = 16                       # global batch (M x DP x 2 rows)
STEPS = 4
LR = 0.1
#: the clean jobs: name -> zero1
JOBS = {"plain": False, "zero1": True}


def case():
    """The deterministic model and data every process derives."""
    rng = np.random.RandomState(0)
    layers = [{"w": (rng.randn(D, D) * 0.3).astype(np.float32),
               "b": (rng.randn(D) * 0.1).astype(np.float32)}
              for _ in range(L)]
    x = rng.randn(B, D).astype(np.float32)
    tgt = rng.randn(B, D).astype(np.float32)
    return layers, x, tgt


def stage_fn_for(stage: int):
    def fn(p, h):
        for j in sorted({n.split("/")[1] for n in p},
                        key=lambda s: int(s[1:])):
            pre = f"{sir.stage_name(stage)}/{j}"
            h = torch.tanh(h @ p[f"{pre}/w"] + p[f"{pre}/b"])
        return h
    return fn


def mse(y, t):
    return torch.mean((y - t) ** 2)


def program(zero1: bool, data_axis: int = DP):
    layers, _, _ = case()
    return mpmd.build_pipeline_ir(
        layer_params=layers, num_stages=S, num_microbatches=M,
        act_nbytes=(B // (M * data_axis)) * D * 4, data_axis=data_axis,
        zero1=zero1, bucket_bytes=1 << 20)


def microbatches(arr, rank: int, dp: int = DP):
    """This DP rank's slice of every microbatch (disjoint halves)."""
    rows = B // (M * dp)
    return [arr[j * dp * rows + rank * rows:j * dp * rows + (rank + 1) * rows]
            for j in range(M)]


def run_job(stage: int, rank: int, workdir: str, zero1: bool,
            state_dir=None) -> None:
    layers, x, tgt = case()
    _, stage_params = mpmd.partition_params(layers, S)
    prog = program(zero1)
    rebuilt = sir.ir_from_facts(
        list(prog.facts), axes=dict(prog.axes),
        accum_steps=int(prog.ir.accum_steps), pipeline=list(prog.pipeline))
    assert rebuilt.fingerprint() == prog.ir.fingerprint()
    runner = mpmd.StageRunner(
        prog, stage, stage_fn=stage_fn_for(stage),
        params=stage_params[stage],
        transport=mpmd.ActivationTransport(os.path.join(workdir, "acts"),
                                           channel=f"dp{rank}",
                                           timeout_s=120.0),
        lr=LR, loss_fn=mse if stage == S - 1 else None, zero1=zero1,
        state_dir=state_dir, device="cpu")
    log = os.path.join(workdir, f"steps.s{stage}r{rank}")
    x_mbs, t_mbs = microbatches(x, rank), microbatches(tgt, rank)
    while runner.step < STEPS:
        loss = runner.run_step(x_mbs if stage == 0 else None,
                               t_mbs if stage == S - 1 else None)
        with open(log, "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "step": runner.step - 1, "loss": float(loss),
                "attempt": int(os.environ.get("AUTODIST_ATTEMPT", "0")),
                "fingerprint": runner.fingerprint}) + "\n")
    names = sorted(runner.params)
    host = [runner.params[n].numpy() for n in names]
    checksum = float(sum(np.abs(h.astype(np.float64)).sum() for h in host))
    digest = hashlib.sha256(b"".join(h.tobytes() for h in host)).hexdigest()
    with open(log, "a", encoding="utf-8") as f:
        f.write(json.dumps({"done": True, "checksum": checksum,
                            "digest": digest,
                            "fingerprint": runner.fingerprint}) + "\n")


def main(stage: int, rank: int, init: str, workdir: str, mode: str) -> None:
    torch.set_num_threads(1)
    torch_launch.init_process_group(init, DP, rank)
    try:
        if mode == "clean":
            for job, zero1 in JOBS.items():
                run_job(stage, rank, os.path.join(workdir, job), zero1)
        else:
            run_job(stage, rank, os.path.join(workdir, "chaos"), True,
                    state_dir=os.path.join(workdir, "chaos", "state"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
