"""Device policy and the host-to-device crossing of the port
(``bigdl_tpu/engine.py``: the ``Engine`` singleton and ``to_device``).

The JAX package discovers its devices through a process-wide singleton.  The
port holds no such state: every entry point takes ``device=``, which defaults
to ``"cuda"`` and is checked here.  Nothing switches to the CPU quietly; the
caller asks for it.  The topology half of ``Engine`` (node and core numbers,
meshes) comes with the distributed slice.
"""

from __future__ import annotations

import itertools
from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def default_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on.  Raises :class:`RuntimeError`
    for a CUDA device when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:   # tensors report "cuda:N", never "cuda"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x: np.ndarray, device: DeviceLike) -> torch.Tensor:
    """Move a host array onto ``device``, keeping its dtype: the single
    host-to-device crossing point of the serving path."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def check_on_device(model: torch.nn.Module, device: torch.device) -> None:
    """Raise :class:`ValueError` unless every parameter and buffer of
    ``model`` lies on ``device`` (an entry point serves the model where the
    caller built it and never moves it behind the caller's back)."""
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        if t.device != device:
            raise ValueError(f"model tensor {name} is on {t.device}, not on "
                             f"{device}: build the model with "
                             f"device={str(device)!r} or move it there")
