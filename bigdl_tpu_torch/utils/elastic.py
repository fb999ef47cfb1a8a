"""The topology record of a snapshot (``bigdl_tpu/utils/elastic.py``:
``TopologyMismatchError`` :75, ``describe_topology`` :112,
``compare_topology`` :133, ``check_restore_topology`` :155).

A snapshot's manifest records the topology that wrote it: the world size,
the ``data`` axis, which trainer's step owns the layout and the axis the
ZeRO-1 slots shard over.  At restore the resuming trainer's topology is
compared with it: the same one restores as it is; another one is
resharded when ``bigdl.elastic.reshardOnRestore`` is on (the default), or
raises :class:`TopologyMismatchError` naming every difference.  A snapshot
holds full per-parameter slots, so resharding is a re-slice: the
data-parallel trainer flattens them and takes its rank's shard, as it does
with any slots it starts from.

Not ported: preemption (``bigdl.elastic.handleSignals`` raises,
``optim/optimizer.py`` ``refuse_unported``) and the hung-step watchdog.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.utils import config

logger = logging.getLogger("bigdl_tpu_torch")

#: the manifest key the topology is stored under
TOPOLOGY_KEY = "topology"


class TopologyMismatchError(RuntimeError):
    """A snapshot's topology differs from the resuming trainer's and
    resharding is off.  ``mismatches`` names every differing field."""

    def __init__(self, saved: Dict[str, Any], current: Dict[str, Any],
                 mismatches: List[str]):
        self.saved = saved
        self.current = current
        self.mismatches = list(mismatches)
        super().__init__(
            "snapshot topology does not match the resuming trainer "
            f"({'; '.join(mismatches)}) and bigdl.elastic.reshardOnRestore "
            "is disabled: enable it to reshard the slots, or resume on the "
            f"saving topology (saved={saved}, current={current})")


def describe_topology(world_size: int = 1, step: str = "local",
                      slot_axis: Optional[str] = None,
                      axes: Optional[Dict[str, int]] = None
                      ) -> Dict[str, Any]:
    """The JSON-serializable topology of a trainer: ``world_size`` ranks
    on a ``data`` axis, or on the named ``axes`` of a mesh (none for one
    local process), the step (``local``, ``distri`` or
    ``tensor_parallel``) and the slots' shard axis (None: unsharded)."""
    if step == "local":
        return {"device_count": 1, "axes": {}, "step": step,
                "slot_axis": slot_axis}
    axes = {"data": int(world_size)} if axes is None else \
        {str(a): int(n) for a, n in axes.items()}
    return {"device_count": int(world_size), "axes": axes, "step": step,
            "slot_axis": slot_axis}


def compare_topology(saved: Optional[Dict[str, Any]],
                     current: Optional[Dict[str, Any]]) -> List[str]:
    """The differences between two topologies; empty when they match.  A
    snapshot without a topology record compares equal to anything."""
    if not saved or not current:
        return []
    out: List[str] = []
    if saved.get("device_count") != current.get("device_count"):
        out.append(f"device_count {saved.get('device_count')} -> "
                   f"{current.get('device_count')}")
    s_axes = saved.get("axes") or {}
    c_axes = current.get("axes") or {}
    for name in sorted(set(s_axes) | set(c_axes)):
        if s_axes.get(name) != c_axes.get(name):
            out.append(f"axis '{name}' {s_axes.get(name)} -> "
                       f"{c_axes.get(name)}")
    if saved.get("step") != current.get("step"):
        out.append(f"step {saved.get('step')!r} -> {current.get('step')!r}")
    return out


def check_restore_topology(saved: Optional[Dict[str, Any]],
                           current: Optional[Dict[str, Any]]) -> str:
    """``"same"``, or ``"reshard"`` when the topology changed and
    ``bigdl.elastic.reshardOnRestore`` allows it; raises
    :class:`TopologyMismatchError` otherwise."""
    mismatches = compare_topology(saved, current)
    if not mismatches:
        return "same"
    if config.get_bool("bigdl.elastic.reshardOnRestore", True):
        logger.info("elastic restore: snapshot topology differs from the "
                    "resuming trainer (%s): resharding the slots",
                    "; ".join(mismatches))
        return "reshard"
    raise TopologyMismatchError(saved or {}, current or {}, mismatches)
