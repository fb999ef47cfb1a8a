"""Multi-threaded image-to-batch assembly and a prefetching transformer
(``bigdl_tpu/dataset/mt_batch.py``; reference
``dataset/image/MTLabeledBGRImgToBatch.scala:46``).

- :func:`assemble_batch` packs N HWC uint8 images into one float32 NCHW
  batch (crop, optional horizontal flip, normalise), and
  :func:`assemble_batch_u8` into a uint8 one (crop, flip, no
  normalisation), both in the native std::thread assembler
  (``native/batch.cc`` through :mod:`bigdl_tpu_torch.dataset.native`,
  built at first use; a failed build raises).
- :func:`crop_flip_host` crops and flips into a uniform NHWC uint8 stack,
  the device-augment path's answer to a batch of mixed frame sizes.
- :class:`MTLabeledBGRImgToBatch` decodes compressed records on a thread
  pool and assembles them, drawing crops and flips from the calling
  thread's :class:`~bigdl_tpu_torch.utils.random_generator.RandomGenerator`.
- :class:`Prefetch` runs its upstream iterator on a producer thread.
"""

from __future__ import annotations

import ctypes
import io
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.native import load_native
from bigdl_tpu_torch.dataset.transformer import Transformer


def _check_crop_fits(images: Sequence[np.ndarray],
                     crop: Tuple[int, int], describe=None) -> None:
    """Every image must be at least crop-sized: the native assembler
    (``native/batch.cc``) does no bounds checks, so an undersized image
    would turn into a negative offset and an out-of-bounds read.
    ``describe(i)`` customizes how the offending image is named (the MT
    transformer names the record and label)."""
    ch, cw = crop
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        if h < ch or w < cw:
            who = describe(i) if describe else f"assemble_batch: image {i}"
            raise ValueError(
                f"{who} is {h}x{w}, smaller than the {ch}x{cw} crop; "
                "resize images to at least the crop size first "
                "(reference pipelines feed pre-resized 256x256 records)")


def assemble_batch(images: Sequence[np.ndarray],
                   crop: Tuple[int, int],
                   offsets: np.ndarray,
                   flips: np.ndarray,
                   mean: Sequence[float],
                   std: Sequence[float],
                   n_threads: int = 4) -> np.ndarray:
    """images: HWC uint8 arrays (any sizes >= crop, enforced); offsets:
    (N, 2) int32 (y, x) crop origins; flips: (N,) uint8.  Returns
    (N, C, crop_h, crop_w) float32: out = (crop(img) - mean) / std,
    optionally h-flipped, in the native assembler."""
    _check_crop_fits(images, crop)
    n = len(images)
    ch, cw = crop
    channels = images[0].shape[2] if images[0].ndim == 3 else 1
    imgs = [np.ascontiguousarray(
        im if im.ndim == 3 else im[:, :, None], dtype=np.uint8)
        for im in images]
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    out = np.empty((n, channels, ch, cw), np.float32)

    lib = load_native()
    ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in imgs])
    heights = np.asarray([im.shape[0] for im in imgs], np.int32)
    widths = np.asarray([im.shape[1] for im in imgs], np.int32)
    lib.assemble_batch(
        ptrs,
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, channels, ch, cw,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(n_threads))
    return out


def assemble_batch_u8(images: Sequence[np.ndarray],
                      crop: Tuple[int, int],
                      offsets: np.ndarray,
                      flips: np.ndarray,
                      n_threads: int = 4) -> np.ndarray:
    """Raw-uint8 sibling of :func:`assemble_batch`: crop + flip + HWC→CHW
    pack WITHOUT normalization — the device-normalize ingest layout (pair
    with ``nn.ChannelNormalize`` on the device), in the native
    assembler."""
    _check_crop_fits(images, crop)
    n = len(images)
    ch, cw = crop
    channels = images[0].shape[2] if images[0].ndim == 3 else 1
    imgs = [np.ascontiguousarray(
        im if im.ndim == 3 else im[:, :, None], dtype=np.uint8)
        for im in images]
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    out = np.empty((n, channels, ch, cw), np.uint8)

    lib = load_native()
    ptrs = (ctypes.c_void_p * n)(
        *[im.ctypes.data_as(ctypes.c_void_p) for im in imgs])
    heights = np.asarray([im.shape[0] for im in imgs], np.int32)
    widths = np.asarray([im.shape[1] for im in imgs], np.int32)
    lib.assemble_batch_u8(
        ptrs,
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n, channels, ch, cw,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        int(n_threads))
    return out


def crop_flip_host(images: Sequence[np.ndarray],
                   crop: Tuple[int, int],
                   offsets: np.ndarray,
                   flips: np.ndarray) -> np.ndarray:
    """Crop + flip on the host into a uniform (N, crop_h, crop_w, C) uint8
    NHWC stack: device-augment ingest packs full frames, which needs one
    frame shape per batch; a batch of mixed sizes is pre-cropped here and
    ships zero offsets and flips, so that ``nn.DeviceAugment`` only
    transposes and the trained weights stay the same."""
    _check_crop_fits(images, crop)
    ch, cw = crop
    n = len(images)
    channels = images[0].shape[2] if images[0].ndim == 3 else 1
    out = np.empty((n, ch, cw, channels), np.uint8)
    for i, im in enumerate(images):
        if im.ndim != 3:
            im = im[:, :, None]
        oy, ox = int(offsets[i, 0]), int(offsets[i, 1])
        patch = im[oy:oy + ch, ox:ox + cw]
        if flips[i]:
            patch = patch[:, ::-1]
        out[i] = patch
    return out


_CV2_LOCK = threading.Lock()
_CV2: list = []          # [cv2 or None] once the import has been tried


def _cv2():
    """OpenCV, or None where it is not installed.  Imported once, under a
    lock (decode workers start together); its import edits the process
    environment (library and Qt plugin paths, which matter only to its own
    GUI), which is put back as it was."""
    if _CV2:
        return _CV2[0]
    with _CV2_LOCK:
        if not _CV2:
            env = dict(os.environ)
            try:
                import cv2
            except ImportError:
                cv2 = None
            finally:
                for key in set(os.environ) - set(env):
                    del os.environ[key]
                for key, value in env.items():
                    if os.environ.get(key) != value:
                        os.environ[key] = value
            _CV2.append(cv2)
    return _CV2[0]


class MTLabeledBGRImgToBatch(Transformer):
    """Compressed byte records → training MiniBatches, multi-threaded.

    Reference equivalent: ``dataset/image/MTLabeledBGRImgToBatch.scala:46``
    — the production ImageNet ingest stage: JPEG decode + crop + flip +
    normalize + pack, parallel on the host, overlapping device compute.

    Consumes :class:`~bigdl_tpu_torch.dataset.image.LabeledImageBytes` records
    (what ``DataSet.seq_file_folder`` holds — compressed bytes, decoded per
    pass) and emits ``MiniBatch(NCHW float32, labels)``.  JPEG decode runs
    on a thread pool (PIL's libjpeg decompression releases the GIL, so the
    pool scales with host cores); crop/flip/normalize/pack runs in the
    native std::thread assembler (``native/batch.cc``).  Crop
    offsets/flips draw from ``RandomGenerator.RNG()`` on the CALLING
    thread (random crop semantics of the reference's CropRandom + HFlip);
    ``random_crop=False`` center-crops deterministically for eval.
    """

    def __init__(self, batch_size: int, crop: Tuple[int, int] = (224, 224),
                 mean: Sequence[float] = (104.0, 117.0, 123.0),
                 std: Sequence[float] = (1.0, 1.0, 1.0),
                 random_crop: bool = True, hflip: bool = True,
                 n_threads: Optional[int] = None,
                 device_normalize: bool = False,
                 rng=None):
        self.batch_size = batch_size
        self.crop = crop
        self.mean, self.std = mean, std
        self.random_crop, self.hflip = random_crop, hflip
        self.n_threads = n_threads or max(1, os.cpu_count() or 1)
        # device_normalize: emit RAW uint8 NCHW (crop/flip/pack only) and
        # leave (x - mean)/std to an nn.ChannelNormalize module on device —
        # quarters the bytes copied to the device
        self.device_normalize = device_normalize
        # rng: draw crop/flip from THIS RandomGenerator instead of the
        # calling thread's stream — the single-drawer contract made
        # explicit, so that a parity check can continue another
        # pipeline's drawer at its exact position
        self._rng = rng

    @staticmethod
    def _decode(data: bytes) -> np.ndarray:
        """JPEG/PNG bytes -> BGR uint8 HWC (the reference's layout): cv2
        where it is installed (it decodes to BGR), else PIL; an
        :class:`ImportError` that names both when neither is."""
        cv2 = _cv2()
        if cv2 is not None:
            img = cv2.imdecode(np.frombuffer(data, np.uint8),
                               cv2.IMREAD_COLOR)
            if img is not None:
                return img
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("decoding a JPEG needs cv2 (opencv-python) "
                              "or PIL (Pillow); neither is installed") from e
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        return rgb[:, :, ::-1]

    def __call__(self, it: Iterator) -> Iterator:
        from concurrent.futures import ThreadPoolExecutor
        from bigdl_tpu_torch.dataset.sample import MiniBatch
        from bigdl_tpu_torch.utils.random_generator import RandomGenerator

        rng = self._rng if self._rng is not None else RandomGenerator.RNG()
        ch, cw = self.crop
        pool = ThreadPoolExecutor(self.n_threads)
        try:
            while True:
                recs = []
                for rec in it:
                    recs.append(rec)
                    if len(recs) == self.batch_size:
                        break
                if not recs:
                    return
                images = list(pool.map(self._decode,
                                       [r.bytes for r in recs]))
                n = len(images)
                offsets = np.empty((n, 2), np.int32)
                flips = np.zeros((n,), np.uint8)
                _check_crop_fits(
                    images, self.crop,
                    describe=lambda i: (
                        f"MTLabeledBGRImgToBatch: record {i} of the "
                        f"current batch (label {recs[i].label})"))
                for i, im in enumerate(images):
                    h, w = im.shape[:2]
                    if self.random_crop:
                        offsets[i] = (rng.random_int(0, h - ch + 1),
                                      rng.random_int(0, w - cw + 1))
                    else:
                        offsets[i] = ((h - ch) // 2, (w - cw) // 2)
                    if self.hflip:
                        flips[i] = rng.uniform() < 0.5
                if self.device_normalize:
                    x = assemble_batch_u8(images, self.crop, offsets, flips,
                                          n_threads=self.n_threads)
                else:
                    x = assemble_batch(images, self.crop, offsets, flips,
                                       self.mean, self.std,
                                       n_threads=self.n_threads)
                y = np.asarray([r.label for r in recs], np.float32)
                yield MiniBatch(x, y)
        finally:
            # cancel_futures: a consumer exiting mid-batch (or a decode
            # error propagating out of pool.map) leaves queued decode
            # futures behind — without cancellation they keep running and
            # pin their records/outputs after the generator is gone
            pool.shutdown(wait=False, cancel_futures=True)


class Prefetch(Transformer):
    """Run the upstream iterator in a daemon thread with a bounded queue
    (the MT producer half of MTLabeledBGRImgToBatch)."""

    def __init__(self, depth: int = 4):
        self.depth = depth

    def __call__(self, it: Iterator) -> Iterator:
        from bigdl_tpu_torch.utils.random_generator import RandomGenerator

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        _END = object()
        # the upstream iterator (and any randomness it draws — MT crop/flip
        # offsets) executes on the producer thread: it must continue the
        # CONSUMING thread's RandomGenerator stream, same contract as
        # Engine.BatchPrefetcher, or a user's set_seed silently stops
        # governing augmentation whenever Prefetch is in the chain.
        # SINGLE-DRAWER CONTRACT: the RandomState is handed off, not
        # shared — for the lifetime of this iterator the producer is the
        # stream's only drawer.  A consumer that keeps drawing host RNG
        # concurrently (a second pipeline on the same thread-local) gets
        # nondeterministic interleaving; run such pipelines on distinct
        # threads (each thread-local RNG is per-thread) or seed a separate
        # RandomGenerator instance for them.
        rng = RandomGenerator.RNG()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            RandomGenerator.adopt(rng)
            try:
                for item in it:
                    if not put(item):
                        return        # consumer abandoned the generator
                put(_END)
            except BaseException as e:  # surface upstream errors downstream
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        # kept on the instance for diagnostics/tests: the teardown
        # contract below (producer joined, queue left empty) is observable
        self._q, self._producer = q, t
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # early exit (break/exception/GeneratorExit): release the
            # producer so it does not pin the upstream iterator forever
            stop.set()

            def drain():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass

            # drain → JOIN → drain: the producer may have passed its stop
            # check and be blocked in put() when we drain — that put lands
            # AFTER the first drain and would pin a full batch in memory
            # forever.  Joining (bounded: the producer exits at its next
            # stop check once the put lands) and draining again guarantees
            # nothing stays queued.
            drain()
            t.join(timeout=5)
            drain()
