"""Augmentation on the device for the real-data path
(``bigdl_tpu/dataset/device_augment.py``).

In device-augment mode the ingest engine ships the full decoded uint8
frames and two small tensors drawn on the host from the clone-and-commit
stream, the crop origins and the flip flags; the crop, the flip and the
NHWC -> NCHW transpose happen here, on the batch's device, in PyTorch ops.
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


def color_jitter(images, seeds, brightness=0.0, contrast=0.0,
                 saturation=0.0):
    """Per-record ColorJitter keyed by ride-along seeds: the JAX package
    draws its factors from ``jax.random.PRNGKey(seed)`` (threefry), which
    the port does not have yet, so it cannot give the same images."""
    raise NotImplementedError(
        "color_jitter: its factors come from JAX's threefry PRNG, which is "
        "not ported yet")
