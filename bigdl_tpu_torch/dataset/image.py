"""Image record types and host-side augmentation transformers
(``bigdl_tpu/dataset/image.py``; reference ``dataset/image/``): decode,
scale, centre and random crops, horizontal flip, channel normalisation,
ColorJitter, PCA lighting and the to-batch converter.

A ``LabeledImage`` holds float32 HWC numpy ``data`` and a float label, in
BGR channel order as the reference keeps it (``dataset/image/Types.scala
:284``).  Random draws come from the thread-local
:class:`~bigdl_tpu_torch.utils.random_generator.RandomGenerator` in the JAX
package's order, so one seed gives both packages the same crops, flips and
jitter.  The device-side normaliser is
:class:`bigdl_tpu_torch.nn.ChannelNormalize`.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random_generator import RandomGenerator


class LocalImgPath:
    """Path + label record (reference ``LocalLabeledImagePath``)."""

    __slots__ = ("path", "label")

    def __init__(self, path: str, label: float = -1.0):
        self.path = path
        self.label = label


class LabeledImageBytes:
    """Compressed (JPEG/PNG) bytes + label: the seq-file record form — kept
    compressed in memory, decoded per pass (reference keeps byte records in
    the cached RDD and decodes in the transformer chain)."""

    __slots__ = ("name", "label", "bytes")

    def __init__(self, name: str, label: float, data: bytes):
        self.name = name
        self.label = label
        self.bytes = data


class BytesToBGRImg(Transformer):
    """Decode LabeledImageBytes → BGR LabeledImage (reference
    ``BytesToBGRImg``)."""

    def __call__(self, it):
        import io
        from PIL import Image
        for rec in it:
            rgb = np.asarray(Image.open(io.BytesIO(rec.bytes))
                             .convert("RGB"), dtype=np.float32)
            yield LabeledImage(rgb[..., ::-1], rec.label)


class LabeledImage:
    """Float HWC image + label (reference ``LabeledBGRImage`` /
    ``LabeledGreyImage``, ``dataset/image/Types.scala``)."""

    __slots__ = ("data", "label")

    def __init__(self, data: np.ndarray, label: float = -1.0):
        self.data = np.asarray(data, dtype=np.float32)
        self.label = label

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def channels(self) -> int:
        return 1 if self.data.ndim == 2 else self.data.shape[2]


# ---------------------------------------------------------------------------
# decode / scale
# ---------------------------------------------------------------------------

def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pure-numpy bilinear resize (no PIL/cv2 dependency on the hot path)."""
    ih, iw = img.shape[:2]
    if ih == h and iw == w:
        return img.astype(np.float32)
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


class LocalImgReader(Transformer):
    """Decode image files to BGR float [0,255], scaling the shorter side to
    ``scale_to`` (reference ``LocalImgReader`` + ``BGRImage.readImage``,
    ``dataset/image/Types.scala:284``)."""

    def __init__(self, scale_to: int = 256):
        self.scale_to = scale_to

    def _decode(self, path: str) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                "image decoding requires PIL; pre-decode to numpy and use "
                "DataSet.array instead") from e
        rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
        return rgb[..., ::-1]  # RGB → BGR, matching reference OpenCV order

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        for rec in it:
            img = _scale_shorter_side(self._decode(rec.path), self.scale_to)
            yield LabeledImage(img, rec.label)


class BGRImgToSample(Transformer):
    """HWC image → CHW Sample (reference ``BGRImgToSample``)."""

    def __init__(self, to_rgb: bool = False):
        self.to_rgb = to_rgb

    def __call__(self, it: Iterator) -> Iterator[Sample]:
        for img in it:
            data = img.data
            if data.ndim == 2:
                data = data[..., None]
            if self.to_rgb:
                data = data[..., ::-1]
            chw = np.ascontiguousarray(np.transpose(data, (2, 0, 1)))
            yield Sample(chw, np.float32(img.label))


class GreyImgToSample(BGRImgToSample):
    pass


# ---------------------------------------------------------------------------
# crops / flips
# ---------------------------------------------------------------------------

def _scale_shorter_side(img: np.ndarray, scale_to: int) -> np.ndarray:
    """Shorter side → ``scale_to``, preserving aspect ratio (the reference
    ``BGRImage.scale`` convention shared by reader and Scale transformer)."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = scale_to, max(1, round(w * scale_to / h))
    else:
        nh, nw = max(1, round(h * scale_to / w)), scale_to
    return _resize_bilinear(img, nh, nw)


class Scale(Transformer):
    """Scale the shorter side to ``scale_to``, preserving aspect ratio
    (reference ``BGRImage.scale`` resize convention)."""

    def __init__(self, scale_to: int):
        self.scale_to = scale_to

    def __call__(self, it: Iterator[LabeledImage]) -> Iterator[LabeledImage]:
        for img in it:
            yield LabeledImage(_scale_shorter_side(img.data, self.scale_to),
                               img.label)


class CenterCrop(Transformer):
    """(reference ``BGRImgCropper`` with CropCenter)."""

    def __init__(self, crop_width: int, crop_height: int):
        self.cw, self.ch = crop_width, crop_height

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        for img in it:
            y = (img.height - self.ch) // 2
            x = (img.width - self.cw) // 2
            yield LabeledImage(img.data[y:y + self.ch, x:x + self.cw],
                               img.label)


class RandomCrop(Transformer):
    """(reference ``BGRImgCropper`` with CropRandom)."""

    def __init__(self, crop_width: int, crop_height: int,
                 padding: int = 0):
        self.cw, self.ch, self.padding = crop_width, crop_height, padding

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in it:
            data = img.data
            if self.padding > 0:
                pads = [(self.padding, self.padding),
                        (self.padding, self.padding)] + \
                       ([(0, 0)] if data.ndim == 3 else [])
                data = np.pad(data, pads)
            h, w = data.shape[:2]
            y = rng.random_int(0, h - self.ch + 1)
            x = rng.random_int(0, w - self.cw + 1)
            yield LabeledImage(data[y:y + self.ch, x:x + self.cw], img.label)


class HFlip(Transformer):
    """Random horizontal flip (reference ``HFlip``)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in it:
            if rng.uniform() < self.threshold:
                yield LabeledImage(img.data[:, ::-1], img.label)
            else:
                yield img


# ---------------------------------------------------------------------------
# normalization / color
# ---------------------------------------------------------------------------

class ChannelNormalize(Transformer):
    """Per-channel (x - mean) / std ON THE HOST (reference
    ``BGRImgNormalizer``).  Means/stds are in the image's channel order
    (BGR for BGR images).

    :class:`bigdl_tpu_torch.nn.ChannelNormalize` is the device-side
    sibling (a module placed first in the model): paired with the uint8
    ingest layout (``MTLabeledBGRImgToBatch(device_normalize=True)``) it
    ships a quarter of the bytes to the card."""

    def __init__(self, means: Sequence[float], stds: Sequence[float]):
        self.means = np.asarray(means, dtype=np.float32)
        self.stds = np.asarray(stds, dtype=np.float32)

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        for img in it:
            data = img.data
            m, s = self.means, self.stds
            if data.ndim == 2:
                m, s = float(m[0]), float(s[0])
            yield LabeledImage((data - m) / s, img.label)


GreyImgNormalizer = ChannelNormalize
BGRImgNormalizer = ChannelNormalize


class ColorJitter(Transformer):
    """Random brightness/contrast/saturation in random order
    (reference ``dataset/image/ColorJitter.scala:36``; operates on BGR
    float [0,255])."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _grayscale(img: np.ndarray) -> np.ndarray:
        # BGR weights (reference uses 0.299R + 0.587G + 0.114B)
        g = (0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2])
        return g[..., None]

    def _blend(self, a, b, alpha):
        return a * alpha + b * (1.0 - alpha)

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in it:
            data = img.data
            order = rng.permutation(3)
            for op in order:
                if op == 0 and self.brightness > 0:
                    alpha = 1.0 + rng.uniform(-self.brightness, self.brightness)
                    data = self._blend(data, np.zeros_like(data), alpha)
                elif op == 1 and self.contrast > 0:
                    alpha = 1.0 + rng.uniform(-self.contrast, self.contrast)
                    mean = self._grayscale(data).mean()
                    data = self._blend(data, np.full_like(data, mean), alpha)
                elif op == 2 and self.saturation > 0:
                    alpha = 1.0 + rng.uniform(-self.saturation, self.saturation)
                    data = self._blend(data, self._grayscale(data), alpha)
            yield LabeledImage(np.clip(data, 0.0, 255.0), img.label)


class Lighting(Transformer):
    """AlexNet-style PCA color noise (reference ``Lighting``); eigen
    vectors/values of ImageNet RGB, applied in BGR order."""

    # ImageNet PCA (RGB order as published); rows re-ordered for BGR data.
    _eigval = np.array([0.2175, 0.0188, 0.0045], dtype=np.float32)
    _eigvec_rgb = np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alphastd: float = 0.1):
        self.alphastd = alphastd
        self._eigvec_bgr = self._eigvec_rgb[::-1]

    def __call__(self, it: Iterator) -> Iterator[LabeledImage]:
        rng = RandomGenerator.RNG()
        for img in it:
            alpha = rng.np.normal(0.0, self.alphastd, size=3).astype(np.float32)
            noise = (self._eigvec_bgr * alpha * self._eigval).sum(axis=1)
            yield LabeledImage(img.data + noise, img.label)


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

class BGRImgToBatch(Transformer):
    """Images → CHW MiniBatch (reference ``BGRImgToBatch``)."""

    def __init__(self, batch_size: int, to_rgb: bool = False):
        self.batch_size = batch_size
        self.to_rgb = to_rgb

    def __call__(self, it: Iterator) -> Iterator[MiniBatch]:
        feats: List[np.ndarray] = []
        labels: List[float] = []
        for img in it:
            data = img.data
            if data.ndim == 2:
                data = data[..., None]
            if self.to_rgb:
                data = data[..., ::-1]
            feats.append(np.transpose(data, (2, 0, 1)))
            labels.append(img.label)
            if len(feats) == self.batch_size:
                yield MiniBatch(np.stack(feats),
                                np.asarray(labels, dtype=np.float32))
                feats, labels = [], []
        if feats:
            yield MiniBatch(np.stack(feats),
                            np.asarray(labels, dtype=np.float32))


GreyImgToBatch = BGRImgToBatch
