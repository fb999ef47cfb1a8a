"""Device policy, the host-to-device crossing and the topology of the port
(``bigdl_tpu/engine.py``: the ``Engine`` singleton :387-445, ``allgather_sum``
:508, and ``to_device``).

The JAX package discovers its devices through a process-wide singleton.  The
port holds no such state: every entry point takes ``device=``, which defaults
to ``"cuda"`` and is checked here.  Nothing switches to the CPU quietly; the
caller asks for it.

The topology is PyTorch's: one process per rank (the ``torchrun`` model),
joined into a ``torch.distributed`` process group by the one explicit call
:meth:`Engine.init_distributed` (NCCL for a CUDA rank, gloo for a CPU one).
Nothing joins a group at import or when a trainer is built.  A "node" of the
reference is a rank of the group and a "core" the one device a rank drives;
the JAX package's meshes have no counterpart (the port is data-parallel
only).
"""

from __future__ import annotations

import itertools
import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

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


class Engine:
    """The topology half of the JAX package's ``Engine`` (reference
    ``utils/Engine.scala:313``), read from the default process group."""

    @staticmethod
    def init_distributed(backend: Optional[str] = None,
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         device: DeviceLike = "cuda") -> None:
        """Join the default process group, the port's only process-wide
        state change.  Without arguments it reads the ``torchrun``
        environment (``init_method="env://"``: ``MASTER_ADDR``,
        ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).  ``backend`` defaults
        to ``"nccl"`` for a CUDA ``device`` and ``"gloo"`` for the CPU; on
        CUDA the rank's device becomes ``LOCAL_RANK`` (else ``rank``
        modulo the visible cards).  No-op when the group exists."""
        if dist.is_initialized():
            return
        dev = default_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        kwargs = {}
        if rank is not None:
            kwargs["rank"] = rank
        if world_size is not None:
            kwargs["world_size"] = world_size
        if dev.type == "cuda":
            local = os.environ.get("LOCAL_RANK")
            if local is None:
                local = (rank if rank is not None
                         else int(os.environ.get("RANK", 0)))
                local %= torch.cuda.device_count()
            torch.cuda.set_device(int(local))
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kwargs)

    @staticmethod
    def node_number() -> int:
        """The ranks of the default group (1 without a group)."""
        return dist.get_world_size() if dist.is_initialized() else 1

    @staticmethod
    def core_number() -> int:
        """Devices a rank drives: one, in the one-process-per-rank model."""
        return 1


def allgather_sum(rows, group: Optional[dist.ProcessGroup] = None
                  ) -> np.ndarray:
    """Sum a small per-rank float array over the group, in float64 (the
    identity without a group).  Collective: every rank calls it with an
    array of the same shape."""
    rows = np.asarray(rows, np.float64)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return rows
    on = ("cuda" if "nccl" in dist.get_backend(group) else "cpu")
    t = torch.from_numpy(rows.copy()).to(on)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu().numpy()
