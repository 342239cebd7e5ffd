"""Minimal image-classifier training on the port.

Twin of ``examples/image_classifier.py``: ResNet-50 under an AutoDist
scope with ``AllReduce``, a few training steps (BASELINE.json's
"ResNet-50 — AllReduce").  For the measured loop use
``benchmark/imagenet.py``.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/image_classifier.py
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None, params=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    args = p.parse_args(argv)
    if args.steps < 1:
        p.error("--steps must be >= 1")

    from autodist_tpu_torch import AutoDist, optim
    from autodist_tpu_torch.models.resnet import resnet50
    from autodist_tpu_torch.strategy import AllReduce

    spec = resnet50(num_classes=100, image_size=args.image_size)
    if params is None:
        params = spec.init(0, device=args.device)

    ad = AutoDist(strategy_builder=AllReduce(), device=args.device)
    with ad.scope():
        ad.capture(params=params, optimizer=optim.sgd(0.1, momentum=0.9),
                   loss_fn=spec.loss_fn)
    sess = ad.create_distributed_session()

    rng = np.random.RandomState(0)
    losses = []
    for step in range(args.steps):
        metrics = sess.run(spec.make_batch(rng, args.batch_size))
        losses.append(float(metrics["loss"]))
        print(f"step {step}: loss {float(metrics['loss']):.4f}")
    assert np.isfinite(float(metrics["loss"]))
    return losses


if __name__ == "__main__":
    main()
