"""VGG on CIFAR-10, the train driver (``bigdl_tpu/models/vgg/train.py``;
reference ``models/vgg/Train.scala``): CIFAR-10 binary batches, BGR
normalisation, ``VggForCifar10``, momentum SGD with weight decay, Top1
validation every epoch.

Run::

    python -m bigdl_tpu_torch.models.vgg.train -f <cifar-folder>
    python -m bigdl_tpu_torch.models.vgg.train --synthetic 512

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.datasets import (CIFAR_MEAN_BGR, CIFAR_STD_BGR,
                                              load_cifar10)
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.vgg import vgg_for_cifar10


def _to_samples(images) -> list:
    mean = np.asarray(CIFAR_MEAN_BGR, dtype=np.float32)
    std = np.asarray(CIFAR_STD_BGR, dtype=np.float32)
    out = []
    for img in images:
        chw = ((img.data - mean) / std).transpose(2, 0, 1)
        out.append(Sample(chw.astype(np.float32), np.float32(img.label)))
    return out


def _synthetic(n: int, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for lab in rng.randint(0, 10, size=n):
        img = rng.normal(0, 0.3, size=(3, 32, 32)).astype(np.float32)
        r, c = divmod(int(lab) % 4, 2)
        img[:, r * 16:(r + 1) * 16, c * 16:(c + 1) * 16] += 1.0 + 0.1 * lab
        out.append(Sample(img, np.float32(lab + 1)))
    return out


def main(argv=None):
    p = driver_utils.base_parser("Train VGG on CIFAR-10")
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 128

    if args.synthetic:
        train, val = _synthetic(args.synthetic), _synthetic(
            max(args.synthetic // 4, 10), seed=2)
    else:
        train = _to_samples(load_cifar10(args.folder, "train"))
        val = _to_samples(load_cifar10(args.folder, "test"))

    model, method = driver_utils.load_snapshots(
        args, lambda: vgg_for_cifar10(10, device=args.device),
        lambda: optim.SGD(learning_rate=args.learning_rate or 0.01,
                          learning_rate_decay=0.0, weight_decay=0.0005,
                          momentum=0.9, dampening=0.0))

    ds = driver_utils.make_dataset(train, args, batch)
    opt = optim.Optimizer.create(model, ds, nn.ClassNLLCriterion(),
                                 device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=90, app_name="vgg")
    opt.set_validation(optim.every_epoch(), val, [optim.Top1Accuracy()],
                       batch_size=batch)
    trained = opt.optimize()

    results = optim.Evaluator(trained, device=args.device).test(
        val, [optim.Top1Accuracy()], batch)
    print(f"Final Top1Accuracy: {results[0][1]}")
    return opt


if __name__ == "__main__":
    main()
