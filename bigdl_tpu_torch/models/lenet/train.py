"""LeNet-5 on MNIST, the train driver (``bigdl_tpu/models/lenet/train.py``;
reference ``models/lenet/Train.scala:35``): MNIST idx files normalised,
``SampleToMiniBatch``, SGD, Top1/Top5/Loss validation every epoch.

Run::

    python -m bigdl_tpu_torch.models.lenet.train -f <mnist-folder> [-b 128]
    python -m bigdl_tpu_torch.models.lenet.train --synthetic 2048
    python -m bigdl_tpu_torch.models.lenet.train --synthetic 256 --device cpu

``main`` returns the optimizer: its ``model`` holds the trained weights,
``history`` the iterations and ``validation_history`` the scores.
"""

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.datasets import (MNIST_TRAIN_MEAN,
                                              MNIST_TRAIN_STD, load_mnist)
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.lenet import lenet5


def _to_samples(images) -> list:
    return [Sample((img.data.astype(np.float32) - MNIST_TRAIN_MEAN) /
                   MNIST_TRAIN_STD, np.float32(img.label))
            for img in images]


def _synthetic(n: int, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for lab in rng.randint(0, 10, size=n):
        img = rng.normal(0, 0.3, size=(28, 28)).astype(np.float32)
        r, c = divmod(int(lab) % 4, 2)
        img[r * 14:(r + 1) * 14, c * 14:(c + 1) * 14] += 1.0 + 0.1 * lab
        out.append(Sample(img, np.float32(lab + 1)))
    return out


def main(argv=None):
    p = driver_utils.base_parser("Train LeNet-5 on MNIST")
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 128

    if args.synthetic:
        train, val = _synthetic(args.synthetic), _synthetic(
            max(args.synthetic // 4, 10), seed=2)
    else:
        train = _to_samples(load_mnist(args.folder, "train"))
        val = _to_samples(load_mnist(args.folder, "test"))

    model, method = driver_utils.load_snapshots(
        args, lambda: lenet5(10, device=args.device),
        lambda: optim.SGD(learning_rate=args.learning_rate or 0.05,
                          learning_rate_decay=0.0))

    ds = driver_utils.make_dataset(train, args, batch)
    opt = optim.Optimizer.create(model, ds, nn.ClassNLLCriterion(),
                                 device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=10, app_name="lenet")
    opt.set_validation(optim.every_epoch(), val,
                       [optim.Top1Accuracy(), optim.Top5Accuracy(),
                        optim.Loss(nn.ClassNLLCriterion())],
                       batch_size=batch)
    trained = opt.optimize()

    results = optim.Evaluator(trained, device=args.device).test(
        val, [optim.Top1Accuracy()], batch)
    print(f"Final Top1Accuracy: {results[0][1]}")
    return opt


if __name__ == "__main__":
    main()
