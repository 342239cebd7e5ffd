"""lm1b LSTM language-model training (synthetic data) on the port,
words/sec.

Twin of ``examples/lm1b/lm1b_train.py``: the 793k-vocab LSTM LM under
``Parallax`` (dense gradients all-reduced, the embedding tables on PS),
with the chunked loss.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/lm1b/lm1b_train.py --vocab-size 4096 \\
        --batch-size 16
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from autodist_tpu_torch import optim  # noqa: E402
from autodist_tpu_torch.models.lm1b import lm1b  # noqa: E402
from examples_torch.benchmark.common import (  # noqa: E402
    benchmark_args, init_params, make_autodist, run_selected_benchmark)


def main(argv=None, params=None):
    p = benchmark_args("lm1b LSTM LM benchmark")
    p.set_defaults(strategy="Parallax")
    p.add_argument("--vocab-size", type=int, default=793472)
    p.add_argument("--seq-len", type=int, default=20)
    p.add_argument("--emb-dim", type=int, default=512)
    p.add_argument("--hidden-dim", type=int, default=2048)
    args = p.parse_args(argv)

    spec = lm1b(vocab_size=args.vocab_size, seq_len=args.seq_len,
                emb_dim=args.emb_dim, hidden_dim=args.hidden_dim)
    ad = make_autodist(args)
    with ad.scope():
        ad.capture(params=init_params(spec, params, args.device),
                   optimizer=optim.adagrad(args.lr),
                   loss_fn=spec.loss_fn, sparse_vars=spec.sparse_vars)
    sess = ad.create_distributed_session()
    return run_selected_benchmark(
        spec, sess, args, unit="words",
        items_per_batch=args.batch_size * args.seq_len)


if __name__ == "__main__":
    main()
