"""Linear regression — the minimal end-to-end example, on the port.

Twin of ``examples/linear_regression.py``: capture a functional program
under ``ad.scope()`` and run distributed steps (``PSLoadBalancing``).

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/linear_regression.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from autodist_tpu_torch import AutoDist, optim  # noqa: E402
from autodist_tpu_torch.strategy import PSLoadBalancing  # noqa: E402

TRUE_W, TRUE_B = 3.0, 2.0
NUM_EXAMPLES = 2000
LR = 0.01
STEPS = 200


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    rng = np.random.RandomState(42)
    inputs = rng.randn(NUM_EXAMPLES).astype(np.float32)
    noises = rng.randn(NUM_EXAMPLES).astype(np.float32)
    outputs = inputs * TRUE_W + TRUE_B + noises * 0.1

    if params is None:
        params = {"w": torch.tensor(5.0), "b": torch.tensor(0.0)}

    def loss_fn(params, batch):
        pred = params["w"] * batch["x"] + params["b"]
        return torch.mean((batch["y"] - pred) ** 2)

    ad = AutoDist(strategy_builder=PSLoadBalancing(), device=args.device)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.sgd(LR), loss_fn=loss_fn)
    sess = ad.create_distributed_session()

    batch = {"x": inputs, "y": outputs}
    losses = []
    for step in range(STEPS):
        metrics = sess.run(batch)
        losses.append(float(metrics["loss"]))
        if step % 50 == 0:
            print(f"step {step:4d} loss {float(metrics['loss']):.5f}")

    final = sess.params
    print(f"learned w={float(final['w']):.3f} (true {TRUE_W}), "
          f"b={float(final['b']):.3f} (true {TRUE_B})")
    assert abs(float(final["w"]) - TRUE_W) < 0.1
    assert abs(float(final["b"]) - TRUE_B) < 0.1
    print("OK")
    return losses


if __name__ == "__main__":
    main()
