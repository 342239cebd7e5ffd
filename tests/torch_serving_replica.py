"""One serving replica of the port for the router drills on the CPU: a
paged engine behind an :class:`~autodist_tpu_torch.serving.server.
EngineServer`, supervised from the parent through heartbeat beacons.

Launched by a :class:`~autodist_tpu_torch.serving.router.
SupervisedReplicaPool` (``tests/test_torch_router.py``'s slow drills):
builds the tests' tiny LM from ``AUTODIST_REPLICA_SEED`` (every replica
of a pool holds identical weights, so greedy decode does not depend on
the replica), starts the server on a free port, publishes the address
atomically to ``AUTODIST_REPLICA_ADDR_FILE``, and beats
``AUTODIST_REPLICA_HB_DIR``/``AUTODIST_REPLICA_NAME`` with the engine's
tick count.  Runs until killed or drained (``serve`` installs the SIGTERM
drain in a supervised replica).
"""
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from autodist_tpu_torch.models.transformer_lm import \
    transformer_lm  # noqa: E402
from autodist_tpu_torch.resilience.heartbeat import \
    HeartbeatWriter  # noqa: E402
from autodist_tpu_torch.serving import serve  # noqa: E402

#: the replica's model: the JAX drill's (vocab 61, 2 layers, width 16)
LM = dict(vocab_size=61, num_layers=2, num_heads=2, head_dim=8, d_ff=32,
          max_len=48, seq_len=16)
GEOM = dict(slots=2, window=32, block_size=8, num_blocks=24, chunk=4)


def main() -> int:
    torch.set_num_threads(1)
    addr_file = os.environ["AUTODIST_REPLICA_ADDR_FILE"]
    hb_dir = os.environ.get("AUTODIST_REPLICA_HB_DIR")
    name = os.environ.get("AUTODIST_REPLICA_NAME", "replica")
    seed = int(os.environ.get("AUTODIST_REPLICA_SEED", "0"))
    spec = transformer_lm(**LM)
    srv = serve(spec, spec.init(seed, device="cpu"), port=0, paged=True,
                device="cpu", **GEOM)
    host, port = srv.address
    writer = None
    if hb_dir:
        writer = HeartbeatWriter(hb_dir, name, interval=0.5).start()
    tmp = addr_file + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"host": host, "port": port, "pid": os.getpid()}, f)
    os.replace(tmp, addr_file)
    eng = srv.engine
    while True:
        time.sleep(0.3)
        if writer is not None:
            writer.beat(step=int(eng.stats.ticks))


if __name__ == "__main__":
    sys.exit(main())
