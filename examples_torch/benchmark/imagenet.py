"""ImageNet-family training benchmark (synthetic data) on the port.

Twin of ``examples/benchmark/imagenet.py``: ResNet-50/101, VGG16,
DenseNet121, InceptionV3 under a chosen strategy, images/sec.

Run (the CUDA card; ``--device cpu`` on the CPU):
    python examples_torch/benchmark/imagenet.py --model resnet50 \\
        --image-size 64 --batch-size 16
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from autodist_tpu_torch import models, optim  # noqa: E402
from examples_torch.benchmark.common import (  # noqa: E402
    benchmark_args, init_params, make_autodist, run_selected_benchmark)


def main(argv=None, params=None):
    p = benchmark_args("ImageNet model-family benchmark")
    p.add_argument("--model", default="resnet50",
                   choices=["resnet50", "resnet101", "vgg16", "densenet121",
                            "inception_v3"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    args = p.parse_args(argv)

    spec = models.ALL_MODELS[args.model](num_classes=args.num_classes,
                                         image_size=args.image_size)
    ad = make_autodist(args)
    with ad.scope():
        ad.capture(params=init_params(spec, params, args.device),
                   optimizer=optim.sgd(args.lr, momentum=0.9),
                   loss_fn=spec.loss_fn,
                   untrainable_vars=spec.untrainable_vars)
    sess = ad.create_distributed_session()
    return run_selected_benchmark(spec, sess, args, unit="images")


if __name__ == "__main__":
    main()
