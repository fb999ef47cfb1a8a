"""Dataset file-format loaders: MNIST idx, CIFAR-10 binary, GloVe, news20,
MovieLens, and deterministic synthetic generators
(``bigdl_tpu/dataset/datasets.py``; reference ``pyspark/bigdl/dataset/``,
``models/vgg/Utils.scala``).  Loaders read local files only; the
``synthetic_*`` generators stand in for data in tests and harnesses.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.image import LabeledImage


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def load_mnist_images(path: str) -> np.ndarray:
    """Parse an MNIST idx3 image file → (N, 28, 28) float32
    (reference ``pyspark/bigdl/dataset/mnist.py`` extract_images)."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx3 magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols).astype(np.float32)


def load_mnist_labels(path: str) -> np.ndarray:
    """Parse an MNIST idx1 label file → (N,) float32, 1-based classes
    (BigDL labels are 1-based: reference models/lenet/Train pipeline)."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx1 magic {magic} in {path}")
        labels = np.frombuffer(f.read(n), dtype=np.uint8)
    return labels.astype(np.float32) + 1.0


# Reference normalization constants (models/lenet/Utils.scala)
MNIST_TRAIN_MEAN = 0.13066047740239506 * 255
MNIST_TRAIN_STD = 0.3081078 * 255


def load_mnist(folder: str, split: str = "train") -> List[LabeledImage]:
    prefix = "train" if split == "train" else "t10k"
    imgs = labels = None
    for suffix in ("-images-idx3-ubyte", "-images.idx3-ubyte"):
        for ext in ("", ".gz"):
            p = os.path.join(folder, prefix + suffix + ext)
            if os.path.exists(p):
                imgs = load_mnist_images(p)
                labels = load_mnist_labels(
                    p.replace("images", "labels").replace("idx3", "idx1"))
                break
        if imgs is not None:
            break
    if imgs is None:
        raise FileNotFoundError(f"no MNIST idx files under {folder}")
    return [LabeledImage(im, lb) for im, lb in zip(imgs, labels)]


# CIFAR-10 BGR means/stds over [0,255] (reference models/vgg/Utils pipeline)
CIFAR_MEAN_BGR = (113.8653, 122.95, 125.307)
CIFAR_STD_BGR = (66.705, 62.089, 62.993)


def load_cifar10(folder: str, split: str = "train") -> List[LabeledImage]:
    """Parse CIFAR-10 binary batches → BGR HWC LabeledImages, 1-based labels."""
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)]
             if split == "train" else ["test_batch.bin"])
    out: List[LabeledImage] = []
    for fname in files:
        path = os.path.join(folder, fname)
        if not os.path.exists(path):
            path = os.path.join(folder, "cifar-10-batches-bin", fname)
        raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
        labels = raw[:, 0].astype(np.float32) + 1.0
        rgb = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        bgr = rgb[..., ::-1].astype(np.float32)
        out.extend(LabeledImage(im, lb) for im, lb in zip(bgr, labels))
    return out


def load_glove(path: str, dim: int = 100) -> Dict[str, np.ndarray]:
    """Parse a GloVe .txt embedding file (reference
    ``pyspark/bigdl/dataset/news20.py`` get_glove_w2v)."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) != dim + 1:
                continue
            out[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
    return out


def load_news20(news_dir: str) -> List[Tuple[str, int]]:
    """Parse an extracted 20-newsgroups tree → [(text, label_id)], labels
    1-based in sorted-subdirectory order (reference
    ``pyspark/bigdl/dataset/news20.py`` get_news20; downloads out of scope —
    the caller points at the extracted ``20_newsgroups`` directory)."""
    texts: List[Tuple[str, int]] = []
    label_id = 0
    for name in sorted(os.listdir(news_dir)):
        path = os.path.join(news_dir, name)
        if not os.path.isdir(path):
            continue
        label_id += 1
        for fname in sorted(os.listdir(path)):
            if not fname.isdigit():
                continue
            with open(os.path.join(path, fname), encoding="latin-1") as f:
                texts.append((f.read(), label_id))
    return texts


def load_movielens(data_dir: str) -> np.ndarray:
    """Parse MovieLens ``ratings.dat`` (``::``-separated) → int array of
    (user, item, rating, timestamp) rows (reference
    ``pyspark/bigdl/dataset/movielens.py`` read_data_sets)."""
    path = os.path.join(data_dir, "ratings.dat")
    if not os.path.exists(path):
        path = os.path.join(data_dir, "ml-1m", "ratings.dat")
    with open(path, "r") as f:
        rows = [line.strip().split("::") for line in f if line.strip()]
    return np.asarray(rows).astype(np.int64)


def movielens_id_pairs(data_dir: str) -> np.ndarray:
    """(user, item) columns (reference get_id_pairs)."""
    return load_movielens(data_dir)[:, 0:2]


def movielens_id_ratings(data_dir: str) -> np.ndarray:
    """(user, item, rating) columns (reference get_id_ratings)."""
    return load_movielens(data_dir)[:, 0:3]


# ---------------------------------------------------------------------------
# synthetic data (tests + perf harnesses)
# ---------------------------------------------------------------------------

def synthetic_images(n: int, channels: int, height: int, width: int,
                     n_classes: int, seed: int = 1) -> List[LabeledImage]:
    rng = np.random.RandomState(seed)
    data = rng.uniform(0, 255, size=(n, height, width, channels)).astype(np.float32)
    labels = rng.randint(1, n_classes + 1, size=n).astype(np.float32)
    return [LabeledImage(d.squeeze() if channels == 1 else d, l)
            for d, l in zip(data, labels)]


def synthetic_separable(n: int, dim: int, n_classes: int = 2,
                        seed: int = 1):
    """Linearly separable clusters (the reference optimizer specs train tiny
    MLPs on such data, ``optim/DistriOptimizerSpec``)."""
    from bigdl_tpu_torch.dataset.sample import Sample
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-4, 4, size=(n_classes, dim)).astype(np.float32)
    labels = rng.randint(0, n_classes, size=n)
    feats = centers[labels] + rng.normal(0, 0.5, size=(n, dim)).astype(np.float32)
    return [Sample(f, np.float32(l + 1)) for f, l in zip(feats, labels)]
