"""The MNIST autoencoder train driver (``bigdl_tpu/models/autoencoder/
train.py``; reference ``models/autoencoder/Train.scala``): images scaled
to [0, 1], trained against themselves with ``MSECriterion`` and Adagrad,
the loss validated every epoch.

Run::

    python -m bigdl_tpu_torch.models.autoencoder.train -f <mnist-folder>
    python -m bigdl_tpu_torch.models.autoencoder.train --synthetic 512

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.datasets import load_mnist
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.autoencoder import FEATURE_SIZE, autoencoder


def _to_samples(images) -> list:
    out = []
    for img in images:
        x = (img.data.astype(np.float32) / 255.0).reshape(-1)
        out.append(Sample(x, x))        # the target is the input
    return out


def _synthetic(n: int, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.uniform(0, 1, size=(FEATURE_SIZE,)) ** 2).astype(np.float32)
        out.append(Sample(x, x))
    return out


def main(argv=None):
    p = driver_utils.base_parser("Train the MNIST autoencoder")
    p.add_argument("--bottleneck", type=int, default=32)
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 150          # reference batchSize=150

    if args.synthetic:
        train = _synthetic(args.synthetic)
        val = _synthetic(max(args.synthetic // 4, 10), seed=2)
    else:
        train = _to_samples(load_mnist(args.folder, "train"))
        val = _to_samples(load_mnist(args.folder, "test"))

    model, method = driver_utils.load_snapshots(
        args, lambda: autoencoder(args.bottleneck, device=args.device),
        lambda: optim.Adagrad(learning_rate=args.learning_rate or 0.01,
                              learning_rate_decay=0.0))

    ds = driver_utils.make_dataset(train, args, batch)
    criterion = nn.MSECriterion()
    opt = optim.Optimizer.create(model, ds, criterion, device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=10,
                           app_name="autoencoder")
    opt.set_validation(optim.every_epoch(), val, [optim.Loss(criterion)],
                       batch_size=batch)
    opt.optimize()
    print("Training done.")
    return opt


if __name__ == "__main__":
    main()
