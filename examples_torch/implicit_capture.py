"""Zero-code-change adoption, on the port: a plain training script
distributed by wrapping it in ``ad.scope()`` — no ``capture()`` call.

Twin of ``examples/implicit_capture.py``: inside the scope the optimizer
built through ``autodist_tpu_torch.optim``, its ``init`` on the
parameters and ``torch.func.grad_and_value`` of the loss are recorded
(``autodist_tpu_torch/patch.py``), and the session is built from them.
The JAX script clips with ``optax.chain(clip_by_global_norm(10.0),
adamw(5e-2))``; the port's ``optim`` has no ``chain`` and implicit capture
takes no numerics options (the guard's ``clip_norm`` needs an explicit
``capture``), so this twin trains ``adamw(5e-2)`` unclipped.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/implicit_capture.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.func  # noqa: E402


def loss_fn(params, batch):
    pred = torch.as_tensor(batch["x"]) @ params["w"] + params["b"]
    return torch.mean((pred - torch.as_tensor(batch["y"])) ** 2)


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)

    from autodist_tpu_torch import AutoDist, optim

    if params is None:
        params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}

    ad = AutoDist(device=args.device)
    with ad.scope():
        # ---- an ordinary single-device script's prefix ----
        optimizer = optim.adamw(5e-2)
        optimizer.init(params)                               # params
        torch.func.grad_and_value(loss_fn)                   # loss_fn
        # ---------------------------------------------------

    session = ad.create_distributed_session()
    rng = np.random.RandomState(0)
    w_true = rng.randn(8, 4).astype(np.float32)
    losses = []
    for step in range(40):
        x = rng.randn(64, 8).astype(np.float32)
        batch = {"x": x, "y": x @ w_true + 0.1}
        metrics = session.run(batch)
        losses.append(float(metrics["loss"]))
        if step % 5 == 0:
            print(f"step {step:3d}  loss {losses[-1]:.5f}  "
                  f"mesh {dict(session.mesh.shape)}")
    assert losses[-1] < losses[0]
    return losses


if __name__ == "__main__":
    main()
