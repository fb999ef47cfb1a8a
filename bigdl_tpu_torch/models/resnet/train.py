"""ResNet, the train driver (``bigdl_tpu/models/resnet/train.py``;
reference ``models/resnet/Train.scala``): CIFAR-10 depth 6n+2 basic-block
ResNets with shortcut A, or with ``--dataset imagenet`` the ImageNet
architectures (shortcut B) on 224 x 224 records; nesterov momentum SGD
with weight decay, ``CrossEntropyCriterion`` on the logits, Top1
validation every epoch.

Run::

    python -m bigdl_tpu_torch.models.resnet.train -f <cifar-folder> --depth 20
    python -m bigdl_tpu_torch.models.resnet.train --synthetic 512 --depth 20
    python -m bigdl_tpu_torch.models.resnet.train --synthetic 512 \\
        --dataset imagenet --depth 50 -b 128 -e 2 --checkpoint /tmp/ckpt

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.dataset.datasets import (CIFAR_MEAN_BGR, CIFAR_STD_BGR,
                                              load_cifar10)
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.resnet import (DatasetType, ShortcutType,
                                           model_init, resnet)


def _cifar_samples(images) -> list:
    mean = np.asarray(CIFAR_MEAN_BGR, dtype=np.float32)
    std = np.asarray(CIFAR_STD_BGR, dtype=np.float32)
    return [Sample(((img.data - mean) / std).transpose(2, 0, 1)
                   .astype(np.float32), np.float32(img.label))
            for img in images]


def _synthetic(n: int, side: int, classes: int, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    out = []
    half = side // 2
    for lab in rng.randint(0, classes, size=n):
        img = rng.normal(0, 0.3, size=(3, side, side)).astype(np.float32)
        r, c = divmod(int(lab) % 4, 2)
        img[:, r * half:(r + 1) * half, c * half:(c + 1) * half] += 1.0
        out.append(Sample(img, np.float32(lab + 1)))
    return out


def main(argv=None):
    p = driver_utils.base_parser("Train ResNet on CIFAR-10 / ImageNet layout")
    p.add_argument("--depth", type=int, default=20,
                   help="20/32/44/56/110 (cifar10) or 18/34/50/101/152/200 "
                        "(imagenet)")
    p.add_argument("--dataset", choices=["cifar10", "imagenet"],
                   default="cifar10")
    p.add_argument("--classes", type=int, default=None)
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()

    imagenet = args.dataset == "imagenet"
    batch = args.batch_size or (64 if imagenet else 128)
    classes = args.classes or (1000 if imagenet else 10)
    side = 224 if imagenet else 32

    if args.synthetic:
        train = _synthetic(args.synthetic, side, min(classes, 4))
        val = _synthetic(max(args.synthetic // 4, 8), side, min(classes, 4),
                         seed=2)
    elif imagenet:
        raise SystemExit(
            "real ImageNet training needs the image-folder pipeline: "
            "point -f at a label-per-subdirectory tree or use --synthetic")
    else:
        train = _cifar_samples(load_cifar10(args.folder, "train"))
        val = _cifar_samples(load_cifar10(args.folder, "test"))

    def build():
        m = resnet(classes, depth=args.depth,
                   shortcut_type=(ShortcutType.B if imagenet
                                  else ShortcutType.A),
                   dataset=(DatasetType.IMAGENET if imagenet
                            else DatasetType.CIFAR10),
                   device=args.device)
        return model_init(m)

    model, method = driver_utils.load_snapshots(
        args, build,
        lambda: optim.SGD(learning_rate=args.learning_rate or 0.1,
                          learning_rate_decay=0.0, weight_decay=1e-4,
                          momentum=0.9, dampening=0.0, nesterov=True))

    ds = driver_utils.make_dataset(train, args, batch)
    opt = optim.Optimizer.create(model, ds, nn.CrossEntropyCriterion(),
                                 device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=165, app_name="resnet")
    opt.set_validation(optim.every_epoch(), val, [optim.Top1Accuracy()],
                       batch_size=batch)
    trained = opt.optimize()

    results = optim.Evaluator(trained, device=args.device).test(
        val, [optim.Top1Accuracy()], batch)
    print(f"Final Top1Accuracy: {results[0][1]}")
    return opt


if __name__ == "__main__":
    main()
