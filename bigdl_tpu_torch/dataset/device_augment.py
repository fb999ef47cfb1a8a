"""Augmentation on the device for the real-data path
(``bigdl_tpu/dataset/device_augment.py``).

In device-augment mode the ingest engine ships the full decoded uint8
frames and two small tensors drawn on the host from the clone-and-commit
stream, the crop origins and the flip flags; the crop, the flip and the
NHWC -> NCHW transpose happen here, on the batch's device, in PyTorch ops.
With ``device_jitter`` the engine also ships one int32 seed per record, and
:func:`color_jitter` draws that record's brightness, contrast and
saturation factors from it with JAX's threefry keys.
"""

from __future__ import annotations

import torch

__all__ = ["crop_flip_transpose", "color_jitter"]


def crop_flip_transpose(frames: torch.Tensor, offsets: torch.Tensor,
                        flips: torch.Tensor, crop_h: int,
                        crop_w: int) -> torch.Tensor:
    """Crop, horizontal flip and NHWC -> NCHW transpose.

    frames:  (N, H, W, C) uint8 full decoded frames
    offsets: (N, 2) integer ``(oy, ox)`` crop origins (host-drawn, in
             bounds: the ingest engine checks that every frame fits)
    flips:   (N,) flip flags
    returns  (N, C, crop_h, crop_w) uint8

    One index gather over the NHWC frames: row ``oy + y`` and column
    ``ox + x``, or ``ox + crop_w - 1 - x`` under ``torch.where`` where the
    flag is set, which is the host path's ``im[oy:oy+ch, ox:ox+cw]`` then
    ``patch[:, ::-1]``, so the bytes are the host assembler's.  The result
    is a ``permute`` view of the (N, crop_h, crop_w, C) gather: NCHW in
    shape, channels-last in memory, ready for a channels-last network
    without another copy."""
    dev = frames.device
    offsets = offsets.to(device=dev, dtype=torch.long)
    flips = flips.to(device=dev) != 0
    ys = offsets[:, :1] + torch.arange(crop_h, device=dev)      # (N, ch)
    xs = torch.arange(crop_w, device=dev)
    cols = offsets[:, 1:] + torch.where(flips[:, None], crop_w - 1 - xs,
                                        xs)                     # (N, cw)
    rows = torch.arange(frames.shape[0], device=dev)[:, None, None]
    patch = frames[rows, ys[:, :, None], cols[:, None, :]]   # (N, ch, cw, C)
    return patch.permute(0, 3, 1, 2)


def color_jitter(images: torch.Tensor, seeds: torch.Tensor,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0) -> torch.Tensor:
    """Per-record ColorJitter over a uint8 NCHW (BGR) batch.

    images: (N, C, H, W) uint8, BGR channel order (the decoders' layout)
    seeds:  (N,) int32 per-record keys, drawn on the host from the
            clone-and-commit stream, so a replayed batch jitters alike
    returns (N, C, H, W) uint8

    Each factor is drawn uniformly from ``[1 - x, 1 + x]`` with JAX's own
    keys (:mod:`bigdl_tpu_torch.utils.prng`: ``PRNGKey(seed)`` split in
    three, one key for brightness, contrast and saturation), so the
    factors are the JAX package's to the bit; a zero leaves its leg out.
    Brightness scales the pixels, contrast pulls them towards the image's
    mean over every channel, saturation towards the BGR luma; the result
    is rounded half to even and held in [0, 255].  The ops are the JAX
    function's, one by one: the image mean (a float32 sum in another
    order) can differ from JAX's in its last bit, which moves a pixel
    that sits at .5 by 1."""
    from bigdl_tpu_torch.utils import prng
    dev = images.device
    keys = prng.split(prng.prng_key(seeds.to(device=dev,
                                             dtype=torch.int32)), 3)
    per_image = (-1, 1, 1, 1)

    def factor(i: int, x: float) -> torch.Tensor:
        return prng.uniform(keys[:, i], 1.0 - x, 1.0 + x).view(per_image)

    x = images.to(torch.float32)
    if brightness:
        x = x * factor(0, brightness)
    if contrast:
        f = factor(1, contrast)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = mean + (x - mean) * f
    if saturation:
        f = factor(2, saturation)
        # BGR luma: channel 0 is blue, 2 is red
        gray = (0.114 * x[:, 0] + 0.587 * x[:, 1] + 0.299 * x[:, 2])[:, None]
        x = gray + (x - gray) * f
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)
