"""Shared harness for the benchmark examples of the PyTorch/CUDA port.

Twin of ``examples/benchmark/common.py``: the same flags (plus
``--device``), one loop for every model family: build the ModelSpec,
capture it under AutoDist, run warmup + timed steps without a host sync
per step, report items/sec.  Runs on the CUDA card unless ``--device``
names another.
"""
import argparse
import time

import numpy as np


def benchmark_args(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--strategy", default="AllReduce",
                   help="strategy builder name (PS, PSLoadBalancing, "
                        "PartitionedPS, AllReduce, PartitionedAR, "
                        "Parallax, …)")
    p.add_argument("--resource-spec", default=None,
                   help="resource_spec.yml path (default: local devices)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=0,
                   help="when >0, train through session.fit (epochs x "
                        "--steps fresh batches) with the TimeHistory "
                        "callback instead of the single-batch timing loop")
    p.add_argument("--device", default=None,
                   help="where to run (default: the CUDA card; 'cpu')")
    return p


def make_autodist(args, mesh_axes=None):
    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import strategy as strategies

    builder = getattr(strategies, args.strategy)()
    return AutoDist(resource_spec_file=args.resource_spec,
                    strategy_builder=builder, mesh_axes=mesh_axes,
                    device=args.device)


def init_params(spec, params, device):
    """``params`` when the caller hands them over, else the spec's init
    from seed 0 (the JAX script's ``PRNGKey(0)``) on ``device``."""
    return spec.init(0, device=device) if params is None else params


def run_benchmark(spec, sess, batch_size: int, steps: int, warmup: int,
                  unit: str = "samples", items_per_batch: int = None):
    """Warmup, then timed steps without a host sync per step (the input
    pipeline re-feeds one pre-placed batch, isolating compute+sync
    throughput)."""
    batch = sess.place_batch(spec.sample_batch(batch_size))
    for _ in range(warmup):
        sess.run(batch, sync=False)
    loss = float(sess.run(batch)["loss"])

    t0 = time.perf_counter()
    for _ in range(steps - 1):
        sess.run(batch, sync=False)
    metrics = sess.run(batch)  # host sync closes the timing window
    dt = time.perf_counter() - t0

    items = (items_per_batch or batch_size) * steps
    rate = items / dt
    print(f"{spec.name}: {rate:,.1f} {unit}/sec "
          f"({steps} steps x batch {batch_size} in {dt:.2f}s), "
          f"loss {loss:.4f} -> {float(metrics['loss']):.4f}")
    assert np.isfinite(float(metrics["loss"]))
    return rate


def run_fit_benchmark(spec, sess, batch_size: int, steps_per_epoch: int,
                      epochs: int, unit: str = "samples",
                      items_per_batch: int = None):
    """Epoch-style benchmark through ``session.fit`` with the
    ``TimeHistory`` callback, fresh batches each epoch flowing through the
    prefetch pipeline."""
    from autodist_tpu_torch import TimeHistory

    def epoch_batches():
        rng = np.random.RandomState(0)
        return (spec.make_batch(rng, batch_size)
                for _ in range(steps_per_epoch))

    th = TimeHistory(items_per_step=items_per_batch or batch_size)
    hist = sess.fit(epoch_batches, epochs=epochs, callbacks=[th])
    for e, (dt, rate) in enumerate(zip(th.epoch_times, th.items_per_sec)):
        print(f"{spec.name}: epoch {e}: {rate:,.1f} {unit}/sec "
              f"({dt:.2f}s), loss {hist.history['epoch_loss'][e]:.4f}")
    assert np.isfinite(hist.history["epoch_loss"][-1])
    return th.items_per_sec[-1]


def run_selected_benchmark(spec, sess, args, unit: str = "samples",
                           items_per_batch: int = None):
    """Dispatch on ``--epochs``: the fit/TimeHistory path when set, the
    single-batch timing loop otherwise."""
    if getattr(args, "epochs", 0):
        return run_fit_benchmark(spec, sess, args.batch_size, args.steps,
                                 args.epochs, unit=unit,
                                 items_per_batch=items_per_batch)
    return run_benchmark(spec, sess, args.batch_size, args.steps,
                         args.warmup, unit=unit,
                         items_per_batch=items_per_batch)
