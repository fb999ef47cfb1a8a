"""The trainers' integrity companion (``bigdl_tpu/integrity/monitor.py``:
``majority_split`` :32, ``replicated_shard_disagreement`` :46, the bitflip
helpers :61-119, ``DriverIntegrity`` :120).

The steps compute fingerprints and the agreement verdict every iteration on
the device and fold them into the update's skip guard, so a corrupted
replica never contaminates healthy state: the run freezes instead.  The loop
reads the small ``aux`` tree on the host every ``bigdl.integrity.everyN``
iterations and hands it to :meth:`DriverIntegrity.check`: a disagreement
between replicas raises :class:`~bigdl_tpu_torch.integrity.errors.
ReplicaDesyncError` naming the minority, a continuity break raises
:class:`~bigdl_tpu_torch.integrity.errors.IntegrityError`, and healthy
verdicts feed the weight-health gates and the ``Integrity/*`` metrics.

In the port a data-parallel replica is a rank: each holds its own copy of
the parameters, fingerprints it, and the ranks all-gather the fingerprints
into the agreement table (the JAX package gathers its devices' copies in
one program).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.integrity.errors import IntegrityError, ReplicaDesyncError
from bigdl_tpu_torch.integrity.fingerprint import NF_SENTINEL
from bigdl_tpu_torch.integrity.health import WeightHealthMonitor

logger = logging.getLogger("bigdl_tpu_torch")


def majority_split(keys: Sequence[bytes]):
    """``(majority_key, minority_indices)`` of bitwise fingerprint keys.
    A tie goes to the key of the lowest-indexed replica: with half the
    replicas corrupted there is no canonical side, and a fixed pick beats
    a coin flip."""
    counts: Dict[bytes, int] = {}
    for k in keys:
        counts[k] = counts.get(k, 0) + 1
    best = max(counts.items(), key=lambda kv: (kv[1], -keys.index(kv[0])))
    major = best[0]
    minority = [i for i, k in enumerate(keys) if k != major]
    return major, minority


def replicated_shard_disagreement(copies) -> Tuple[List[int], List[bytes]]:
    """Bitwise comparison of the replicas' copies of one replicated value
    (tensors or arrays, one per replica, in replica order):
    ``(minority_indices, per_copy_bytes)``."""
    keys = [(c.detach().cpu().numpy() if isinstance(c, torch.Tensor)
             else np.asarray(c)).tobytes() for c in copies]
    _, minority = majority_split(keys)
    return minority, keys


#: the flipped bit of each element width: about 2**-11 of the element's
#: magnitude in float32, far above the float64 fingerprint's resolution
#: and far below anything a loss curve shows
_FLIP = {2: (torch.int16, 2), 4: (torch.int32, 12), 8: (torch.int64, 40)}


def _flip_in_place(t: torch.Tensor) -> None:
    """One mid-mantissa bit of ``t``'s first element flipped, in place:
    finite, invisible to the divergence guard."""
    idtype, bit = _FLIP[t.element_size()]
    with torch.no_grad():
        word = t.detach().reshape(-1)[:1].view(idtype)
        word.bitwise_xor_(1 << bit)


def bitflip_tree(tree, leaf_index: int = 0) -> Optional[int]:
    """Injected silent corruption for one logical copy: one mid-mantissa
    bit of the first element of float tensor ``leaf_index`` (modulo their
    count) of ``tree`` (a list, or a dict in insertion order) flips, in
    place.  Returns the flipped tensor's position, None when there is no
    float tensor."""
    leaves = list(tree.values()) if isinstance(tree, dict) else list(tree)
    pos = [i for i, t in enumerate(leaves)
           if isinstance(t, torch.Tensor) and t.is_floating_point()
           and t.numel()]
    if not pos:
        return None
    i = pos[leaf_index % len(pos)]
    _flip_in_place(leaves[i])
    return i


def bitflip_one_replica(flat: torch.Tensor, replica: int, rank: int,
                        world: int) -> bool:
    """Injected silent corruption for one data-parallel replica: rank
    ``replica`` (modulo ``world``) flips one bit of the first element of
    its own copy of the flat parameter vector; every other rank's copy is
    untouched, so only the agreement table sees it.  True on the rank that
    flipped."""
    if rank != replica % world:
        return False
    _flip_in_place(flat)
    return True


def _pull(aux: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every value of ``aux`` but the carry on the host, in one copy (a
    device's tensors are concatenated first)."""
    vals = {k: torch.as_tensor(v) for k, v in aux.items()
            if k != "fpc" and v is not None}
    keys = sorted(vals)
    if not keys:
        return {}
    dev = vals[keys[0]].device
    flat = torch.cat([vals[k].detach().reshape(-1).to(dev, torch.float64)
                      for k in keys]).cpu().numpy()
    out, off = {}, 0
    for k in keys:
        shape = tuple(vals[k].shape)
        n = int(np.prod(shape)) if shape else 1
        out[k] = flat[off:off + n].reshape(shape)
        off += n
    return out


class DriverIntegrity:
    """A run's integrity state, handed to the trainers' loop: the name
    table of the non-finite culprit, the check cadence, the weight-health
    gates and the verdict classifier."""

    def __init__(self, family: str, nf_names: Sequence[str],
                 every_n: int = 0,
                 health: Optional[WeightHealthMonitor] = None):
        self.family = family
        self.nf_names = list(nf_names)
        self.every_n = int(every_n)
        self.health = health
        self.checks = 0

    @property
    def enabled(self) -> bool:
        return self.every_n > 0

    def due(self, neval: int) -> bool:
        return self.enabled and neval % self.every_n == 0

    # -- diagnosed divergence -------------------------------------------

    def describe_nonfinite(self, idx: int) -> str:
        """The suffix of the bad-step log line and ``DivergenceError``:
        which tree and leaf went non-finite first (empty for the sentinel,
        e.g. a NaN loss the chaos harness reported)."""
        if idx == NF_SENTINEL or idx < 0:
            return ""
        if idx < len(self.nf_names):
            return f"; first non-finite: {self.nf_names[idx]}"
        return f"; first non-finite: float leaf #{idx}"

    # -- fingerprint verdicts -------------------------------------------

    def _bad_iteration(self, vals: Dict[str, Any], neval: int) -> int:
        it = int(float(vals.get("bad_iter", 0.0)))
        return it if it > 0 else neval

    def check(self, aux: Dict[str, Any], neval: int) -> None:
        """Classify one step's verdicts (device tensors, read here in one
        copy).  Raises on corruption; feeds the health gates and gauges
        otherwise."""
        self.checks += 1
        telemetry.counter(
            "Integrity/checks",
            help="driver-side fingerprint verdicts pulled").inc()
        vals = _pull(aux)
        fps_all = vals.get("fps_all")
        if fps_all is not None:
            keys = [fps_all[i].tobytes() for i in range(fps_all.shape[0])]
            _, minority = majority_split(keys)
            if minority:
                self._raise_desync(minority, fps_all, vals, neval)
        if float(vals.get("cont", 0.0)) > 0:
            telemetry.counter(
                "Integrity/continuity_failures",
                help="fingerprint continuity breaks between steps (silent "
                     "in-memory corruption)").inc()
            it = self._bad_iteration(vals, neval)
            raise IntegrityError(
                f"training-state fingerprint continuity broke at iteration "
                f"{it} (observed at iteration {neval}; {self.family} "
                "step): parameters or optimizer slots changed outside the "
                "step while every value stayed finite - restoring the "
                "latest valid snapshot", iteration=it)
        self._observe_health(vals, neval)

    def _raise_desync(self, minority: List[int], fps, vals,
                      neval: int) -> None:
        telemetry.counter(
            "Integrity/desync_detected",
            help="cross-replica fingerprint disagreements").inc()
        it = self._bad_iteration(vals, neval)
        raise ReplicaDesyncError(
            f"data-parallel replica(s) {minority} disagree on the parameter "
            f"fingerprint at iteration {it} (observed at iteration {neval}; "
            f"{self.family} step) - healing by re-broadcasting canonical "
            "state from the agreeing majority", replicas=minority,
            iteration=it, fingerprints=fps)

    # -- weight health ---------------------------------------------------

    def _observe_health(self, vals: Dict[str, Any], neval: int) -> None:
        pn = float(vals.get("pn", float("nan")))
        un = float(vals.get("un", float("nan")))
        gn = float(vals.get("gn", float("nan")))
        if not math.isfinite(pn):
            return
        param_norm = math.sqrt(max(pn, 0.0))
        update_norm = math.sqrt(max(un, 0.0))
        grad_norm = math.sqrt(max(gn, 0.0))
        ratio = update_norm / max(param_norm, 1e-12)
        telemetry.gauge("Integrity/param_norm", summary=True).set(param_norm)
        telemetry.gauge("Integrity/update_norm", summary=True).set(
            update_norm)
        telemetry.gauge("Integrity/grad_norm", summary=True).set(grad_norm)
        telemetry.gauge("Integrity/update_ratio", summary=True).set(ratio)
        pb = np.asarray(vals.get("pb", ()), dtype=np.float64).ravel()
        ub = np.asarray(vals.get("ub", ()), dtype=np.float64).ravel()
        bucket_ratios = []
        for i in range(min(pb.size, ub.size)):
            r = math.sqrt(max(float(ub[i]), 0.0)) / max(
                math.sqrt(max(float(pb[i]), 0.0)), 1e-12)
            bucket_ratios.append(r)
            telemetry.gauge("Integrity/bucket_update_ratio",
                            labels={"bucket": str(i)}).set(r)
        if self.health is not None and self.health.enabled:
            self.health.observe("grad_norm", grad_norm, neval)
            self.health.observe("update_ratio", ratio, neval)
            for i, r in enumerate(bucket_ratios):
                self.health.observe(f"update_ratio_b{i}", r, neval)
