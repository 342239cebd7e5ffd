"""BERT pre-training benchmark (synthetic MLM data) on the port.

Twin of ``examples/benchmark/bert.py``: samples/sec.  The model keeps its
default attention: the flash kernels on the card, dense on the CPU.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/benchmark/bert.py --size tiny --batch-size 8
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch.models.bert import bert, bert_base, \
    bert_large  # noqa: E402
from examples_torch.benchmark.common import (  # noqa: E402
    benchmark_args, init_params, make_autodist, run_selected_benchmark)

SIZES = {
    "tiny": lambda **kw: bert(num_layers=2, num_heads=2, head_dim=32,
                              d_ff=256, vocab_size=1024, **kw),
    "base": bert_base,
    "large": bert_large,
}


def main(argv=None, params=None):
    p = benchmark_args("BERT pre-training benchmark")
    p.add_argument("--size", default="base", choices=sorted(SIZES))
    p.add_argument("--seq-len", type=int, default=128)
    args = p.parse_args(argv)

    spec = SIZES[args.size](seq_len=args.seq_len)
    ad = make_autodist(args)
    with ad.scope():
        ad.capture(params=init_params(spec, params, args.device),
                   optimizer=optim.adamw(args.lr),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    return run_selected_benchmark(spec, sess, args, unit="samples")


if __name__ == "__main__":
    main()
