"""Inception v1/v2 on ImageNet, the train driver
(``bigdl_tpu/models/inception/train.py``; reference
``models/inception/Train.scala:39``): the SequenceFile pipeline, SGD with
poly learning-rate decay.

``-f`` points at a SequenceFile tree (``DataSet.seq_file_folder``), or
``--synthetic N`` makes N records.

Run::

    python -m bigdl_tpu_torch.models.inception.train --synthetic 64 -b 16

``main`` returns the optimizer (``model``, ``history``,
``validation_history``).
"""

import numpy as np

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import Sample
from bigdl_tpu_torch.models import driver_utils
from bigdl_tpu_torch.models.inception import (inception_v1_no_aux_classifier,
                                              inception_v2_no_aux_classifier)


def _synthetic(n: int, classes: int, seed: int = 1) -> list:
    rng = np.random.RandomState(seed)
    out = []
    for lab in rng.randint(0, min(classes, 4), size=n):
        img = rng.normal(0, 0.3, size=(3, 224, 224)).astype(np.float32)
        r, c = divmod(int(lab) % 4, 2)
        img[:, r * 112:(r + 1) * 112, c * 112:(c + 1) * 112] += 1.0
        out.append(Sample(img, np.float32(lab + 1)))
    return out


def _seqfile_dataset(folder: str, batch: int, partitions: int):
    """The lazy ImageNet pipeline: SequenceFile records decoded, scaled,
    cropped, normalised and batched on each pass."""
    from bigdl_tpu_torch.dataset.dataset import DataSet
    from bigdl_tpu_torch.dataset.image import (BGRImgNormalizer,
                                               BGRImgToSample, CenterCrop,
                                               Scale)
    from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
    ds = DataSet.seq_file_folder(folder)
    return (ds.transform(Scale(256)).transform(CenterCrop(224, 224))
              .transform(BGRImgNormalizer((104.0, 117.0, 123.0),
                                          (1.0, 1.0, 1.0)))
              .transform(BGRImgToSample())
              .transform(SampleToMiniBatch(batch, max(1, partitions))))


def main(argv=None):
    p = driver_utils.base_parser("Train Inception v1/v2 (ImageNet layout)")
    p.add_argument("--version", choices=["v1", "v2"], default="v1")
    p.add_argument("--classes", type=int, default=1000)
    args = driver_utils.parse(p, argv)
    driver_utils.init_logging()
    batch = args.batch_size or 32

    if args.synthetic:
        train = _synthetic(args.synthetic, args.classes)
        val = _synthetic(max(args.synthetic // 4, 8), args.classes, seed=2)
        ds = driver_utils.make_dataset(train, args, batch)
    else:
        # validation needs its own folder in a real deployment (reference
        # Train.scala takes train and val directories)
        ds = _seqfile_dataset(args.folder, batch, args.partitions)
        val = None

    build = (inception_v1_no_aux_classifier if args.version == "v1"
             else inception_v2_no_aux_classifier)

    model, method = driver_utils.load_snapshots(
        args, lambda: build(args.classes, device=args.device),
        lambda: optim.SGD(learning_rate=args.learning_rate or 0.01,
                          learning_rate_decay=0.0, weight_decay=0.0002,
                          momentum=0.9,
                          learning_rate_schedule=optim.Poly(0.5, 62000)))

    opt = optim.Optimizer.create(model, ds, nn.ClassNLLCriterion(),
                                 device=args.device)
    opt.set_optim_method(method)
    driver_utils.configure(opt, args, default_epochs=10,
                           app_name="inception")
    if val is not None:
        opt.set_validation(optim.every_epoch(), val,
                           [optim.Top1Accuracy(), optim.Top5Accuracy()],
                           batch_size=batch)
    opt.optimize()
    print("Training done.")
    return opt


if __name__ == "__main__":
    main()
