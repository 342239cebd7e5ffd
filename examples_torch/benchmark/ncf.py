"""NCF (neural collaborative filtering) benchmark on the port, samples/sec.

Twin of ``examples/benchmark/ncf.py``.  The user/item embedding tables
are the sparse-gradient variables; under the PS family they are stored
1/N per rank between steps at data size > 1.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/benchmark/ncf.py --num-users 1024 --num-items 512
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch.models.ncf import ncf  # noqa: E402
from examples_torch.benchmark.common import (  # noqa: E402
    benchmark_args, init_params, make_autodist, run_selected_benchmark)


def main(argv=None, params=None):
    p = benchmark_args("NCF benchmark")
    p.set_defaults(strategy="PSLoadBalancing", batch_size=256)
    p.add_argument("--num-users", type=int, default=138496)
    p.add_argument("--num-items", type=int, default=26752)
    args = p.parse_args(argv)

    spec = ncf(num_users=args.num_users, num_items=args.num_items)
    ad = make_autodist(args)
    with ad.scope():
        ad.capture(params=init_params(spec, params, args.device),
                   optimizer=optim.adam(args.lr),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    return run_selected_benchmark(spec, sess, args, unit="samples")


if __name__ == "__main__":
    main()
