#!/usr/bin/env python3
"""The LeNet leg of ``accuracy.py``'s epochs-to-accuracy protocol, through
the PyTorch port's driver.

scikit-learn's bundled UCI optical digits (1797 real handwritten digits)
are upscaled to 28 x 28, written as MNIST idx files into a temporary
folder, split 1438 / 359 by ``accuracy.py``'s seeded permutation, and
trained by ``bigdl_tpu_torch.models.lenet.train`` (its idx reader and
normalisation) for 15 epochs at B32, lr 0.05; the driver's final Top1
on the test split is the result.  ``--seed`` seeds the generator of the
epoch shuffles (default 5489, as ``accuracy.py``); the initial weights are
the driver's own (``lenet5``'s seed 0) unless ``--init-seed`` draws them
from another seed, handed to the driver as its ``--model`` snapshot.  The
two together give the spread of the protocol's result over its draws.  The JAX
package's run of the same protocol is pinned at 0.9833 in
``ACCURACY_r05.json``.

The upscale is torch's bilinear ``interpolate`` (``align_corners=False``),
where ``accuracy.py`` uses ``jax.image.resize(..., "bilinear")``: for an
upscale both are the same triangle filter with half-pixel centres, the
edges clamped, so they agree to float rounding.

Needs scikit-learn (no download: the digits ship with it).  Run::

    python accuracy_torch.py --device cpu [--seed N] [--init-seed N]
                             [--out record.json]
"""

import argparse
import io
import json
import os
import re
import struct
import sys
import tempfile
from contextlib import redirect_stdout

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def write_idx_images(path: str, images: np.ndarray) -> None:
    """MNIST idx3 format: magic 0x803, dims, uint8 payload."""
    n, h, w = images.shape
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", 0x803, n, h, w))
        f.write(images.astype(np.uint8).tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(">II", 0x801, labels.shape[0]))
        f.write(labels.astype(np.uint8).tobytes())


def digits_split(side: int, test_fraction: float = 0.2, seed: int = 0):
    """The digits upscaled to ``side`` x ``side`` [0, 255] uint8 and
    ``accuracy.py``'s seeded train/test split."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise SystemExit("accuracy_torch.py needs scikit-learn, whose "
                         "bundled digits it trains on") from e
    import torch
    import torch.nn.functional as F

    d = load_digits()
    x = torch.from_numpy(d.images.astype(np.float32))[:, None]
    imgs = F.interpolate(x, size=(side, side), mode="bilinear",
                         align_corners=False)[:, 0].numpy()
    imgs = np.clip(imgs * (255.0 / 16.0), 0, 255).astype(np.uint8)
    labels = d.target.astype(np.uint8)
    order = np.random.RandomState(seed).permutation(len(imgs))
    n_test = int(len(imgs) * test_fraction)
    return imgs, labels, order[n_test:], order[:n_test]


def make_digits_idx(folder: str, test_fraction: float = 0.2, seed: int = 0):
    """Write the digits as MNIST-protocol idx files into ``folder``."""
    imgs, labels, train, test = digits_split(28, test_fraction, seed)
    write_idx_images(os.path.join(folder, "train-images-idx3-ubyte"),
                     imgs[train])
    write_idx_labels(os.path.join(folder, "train-labels-idx1-ubyte"),
                     labels[train])
    write_idx_images(os.path.join(folder, "t10k-images-idx3-ubyte"),
                     imgs[test])
    write_idx_labels(os.path.join(folder, "t10k-labels-idx1-ubyte"),
                     labels[test])
    return len(train), len(test)


def run_lenet(args) -> dict:
    from bigdl_tpu_torch.models.lenet import train as drv
    from bigdl_tpu_torch.utils.random_generator import RandomGenerator

    with tempfile.TemporaryDirectory() as folder:
        n_train, n_test = make_digits_idx(folder)
        _log(f"digits-as-idx: {n_train} train / {n_test} test")
        init = []
        if args.init_seed is not None:
            from bigdl_tpu_torch.models.lenet import lenet5
            from bigdl_tpu_torch.utils import file_io
            from bigdl_tpu_torch.utils.checkpoint_manager import \
                model_payload
            path = os.path.join(folder, "init.model")
            file_io.save(model_payload(lenet5(10, device="cpu",
                                              seed=args.init_seed)), path)
            init = ["--model", path]
        RandomGenerator.RNG().set_seed(args.seed)
        buf = io.StringIO()
        with redirect_stdout(buf):
            drv.main(["-f", folder, "-b", str(args.batch), "--max-epoch",
                      str(args.epochs), "-r", str(args.lr), "--device",
                      args.device] + init)
    out = buf.getvalue()
    sys.stderr.write(out)
    m = re.search(r"Final Top1Accuracy:.*?([0-9.]+)", out)
    if not m:
        raise SystemExit("the driver reported no final accuracy")
    return {"metric": "lenet_digits_top1", "value": round(float(m.group(1)),
                                                          4),
            "unit": "accuracy",
            "config": {"dataset": "sklearn-digits as 28x28 idx files",
                       "driver": "bigdl_tpu_torch.models.lenet.train",
                       "device": args.device, "epochs": args.epochs,
                       "batch": args.batch, "lr": args.lr,
                       "seed": args.seed, "init_seed": args.init_seed,
                       "train": n_train, "test": n_test},
            "reference": {"value": 0.9833, "source": "ACCURACY_r05.json"}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=5489,
                    help="the seed of the epoch shuffles")
    ap.add_argument("--init-seed", type=int, default=None,
                    help="draw the initial weights from this seed (default: "
                         "the driver's own)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="also write the record to this JSON file")
    args = ap.parse_args(argv)
    record = run_lenet(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
