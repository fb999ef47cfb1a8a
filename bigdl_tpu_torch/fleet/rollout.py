"""Blue/green rollout: the gated state machine behind every model swap
(``bigdl_tpu/fleet/rollout.py``).

::

    PREPARE ──► VERIFY ──► SHADOW ──► CUTOVER ──► DRAIN
       │           │          │          (atomic router swap; the
       │           │          │           incumbent replicas then drain
       │           │          │           via stop(grace) — zero
       │           │          │           requests lost)
       └───────────┴──────────┴──► ROLLBACK (candidate retired, the
                                   incumbent NEVER stopped serving)

* **PREPARE**: the candidate's semantic fingerprint (over its parameter
  tensors) is taken FIRST; then its replicas are built, each running one
  forward per ``bigdl.compile.buckets`` size before the candidate sees one
  live request.
* **VERIFY**: the fingerprint is taken again just before cutover and must
  match: weights that changed anywhere between prepare and cutover
  (``bigdl.chaos.corruptCandidateAt`` models this) are refused.  A
  promotion from a checkpoint has had its save-time fingerprint verified
  earlier, inside ``CheckpointManager.load_latest``; this leg covers the
  load-to-cutover window on top.
* **SHADOW**: up to ``bigdl.fleet.shadowSample`` recently COMPLETED live
  requests are replayed, one at a time, through the candidate and compared
  with the incumbent's answers: bit for bit when ``bigdl.fleet.parityMode``
  is ``bitwise`` (an identical-weights swap must not change one bit),
  ``np.allclose(parityRtol, parityAtol)`` for ``allclose``, or skipped for
  ``off`` (a deliberately different model legitimately diverges).  A
  replayed row runs alone, padded to the smallest bucket, where the
  incumbent may have served it inside a larger batch: ``bitwise`` holds
  only where a row's output does not depend on its batch (PERF.md,
  phase 21).
* **CUTOVER**: one pointer swap under the service lock: requests admitted
  before it complete on the old replicas, requests after it route to the
  new ones, with no window where neither side serves.
* **DRAIN**: the old replicas retire through the engine's graceful
  ``stop(grace)``; queued work completes (or sheds retriably past the grace
  window, still accounted).

A fleet-wide preemption (``elastic.preemption_requested``) seen at any
phase boundary aborts into ROLLBACK: a SIGTERM mid-rollout never leaves the
router pointing at a half-warmed candidate.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.telemetry import incident
from bigdl_tpu_torch.utils import chaos, config, elastic

logger = logging.getLogger("bigdl_tpu_torch")


@dataclass
class RolloutReport:
    """What one rollout did and how long each phase took.  Returned for
    promoted AND rolled-back rollouts: the caller branches on
    :attr:`promoted`; a rollback is an answered question, not an
    exception."""

    service: str
    from_version: str
    to_version: str
    promoted: bool = False
    rolled_back: bool = False
    reason: str = ""
    fingerprint_expected: Optional[str] = None
    fingerprint_observed: Optional[str] = None
    parity_mode: str = "bitwise"
    parity_checked: int = 0
    parity_max_abs_diff: float = 0.0
    prepare_ms: float = 0.0
    verify_ms: float = 0.0
    shadow_ms: float = 0.0
    drain_ms: float = 0.0
    #: rollout start -> traffic on the candidate, wall time
    swap_ms: float = 0.0
    cutover_ns: Optional[int] = None
    replicas: int = 0
    notes: List[str] = field(default_factory=list)


def _params_fingerprint(model) -> str:
    """Fingerprint key over the model's parameter tensors, in their order
    (a host copy of each, float64 accumulation): the semantic identity of
    the weights across prepare, build and cutover."""
    from bigdl_tpu_torch.integrity import fingerprint_key, host_fingerprint
    return fingerprint_key(host_fingerprint(list(model.parameters())))


def _leaves(obj, out: List[Tuple[np.ndarray, str]]) -> None:
    """``(values, dtype name)`` of every array in an output: tensors,
    ndarrays and scalars, through tuples, lists and dicts (dicts in sorted
    key order, as a pytree flattens them).  A bfloat16 tensor's values come
    out as float32, which holds each of them exactly."""
    if obj is None:
        return
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        out.append((t.numpy(), dtype))
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out)
    else:
        a = np.asarray(obj)
        out.append((a, str(a.dtype)))


def _parity_compare(got, want, mode: str, rtol: float,
                    atol: float) -> Tuple[bool, float]:
    """(outputs agree, max abs elementwise difference seen).  Another
    structure, shape or dtype never agrees (difference inf)."""
    la: List[Tuple[np.ndarray, str]] = []
    lb: List[Tuple[np.ndarray, str]] = []
    _leaves(got, la)
    _leaves(want, lb)
    if len(la) != len(lb):
        return False, float("inf")
    worst = 0.0
    ok = True
    for (x, dx), (y, dy) in zip(la, lb):
        if x.shape != y.shape or dx != dy:
            return False, float("inf")
        if x.size:
            with np.errstate(invalid="ignore"):
                worst = max(worst, float(np.max(np.abs(
                    x.astype(np.float64) - y.astype(np.float64)))))
        if mode == "bitwise":
            ok = ok and bool(np.array_equal(x, y))
        else:
            ok = ok and bool(np.allclose(x, y, rtol=rtol, atol=atol))
    return ok, worst


def run_rollout(service, candidate_model,
                expected_fingerprint: Optional[str] = None,
                replicas: Optional[int] = None,
                parity: Optional[str] = None,
                grace: Optional[float] = None) -> RolloutReport:
    """Drive one candidate through the state machine against ``service``
    (a ``fleet._Service``).  Serialized per service by the rollout lock:
    two concurrent rollouts of one service would race the router.  See the
    module docstring for the phases."""
    mode = (parity if parity is not None else
            str(config.get_property("bigdl.fleet.parityMode") or "bitwise"))
    if mode not in ("bitwise", "allclose", "off"):
        raise ValueError(f"unknown parity mode {mode!r} "
                         "(bitwise | allclose | off)")
    rtol = config.get_float("bigdl.fleet.parityRtol", 1e-5)
    atol = config.get_float("bigdl.fleet.parityAtol", 1e-6)
    shadow_n = config.get_int("bigdl.fleet.shadowSample", 8)
    grace = (grace if grace is not None else
             config.get_float("bigdl.fleet.gracePeriod", 5.0))

    with service._rollout_lock:
        t0 = telemetry.clock_ns()
        report = RolloutReport(
            service=service.name, from_version=service.version,
            to_version=service.peek_next_version(), parity_mode=mode)
        new: List[Any] = []

        def rollback(reason: str, slug: str) -> RolloutReport:
            for r in new:
                # the candidate never entered the router: nothing queued
                # beyond our own shadow replays, so a zero-grace retire is
                # clean
                r.retire(0.0)
            report.rolled_back = True
            report.reason = reason
            telemetry.counter("Fleet/rollbacks",
                              labels={"service": service.name,
                                      "reason": slug}).inc()
            incident.record("fleet/rollback", service=service.name,
                            from_version=report.from_version,
                            to_version=report.to_version, cause=slug,
                            reason=reason)
            logger.warning("fleet %s: rollout %s -> %s ROLLED BACK (%s) — "
                           "incumbent keeps serving", service.name,
                           report.from_version, report.to_version, reason)
            return report

        # ---- PREPARE ---------------------------------------------------
        report.fingerprint_expected = (
            expected_fingerprint if expected_fingerprint is not None
            else _params_fingerprint(candidate_model))
        # chaos window: the candidate's weights rot AFTER the expected
        # fingerprint was taken, exactly what VERIFY must catch
        chaos.corrupt_candidate(candidate_model)
        if elastic.preemption_requested():
            return rollback("preempted before prepare", "preempted")
        n = int(replicas if replicas is not None
                else (len(service.active_replicas()) or 1))
        report.replicas = n
        try:
            for _ in range(n):
                new.append(service.new_replica(candidate_model,
                                               report.to_version))
        except Exception as e:
            return rollback(f"candidate prepare failed: {e!r}", "prepare")
        report.prepare_ms = (telemetry.clock_ns() - t0) / 1e6

        # ---- VERIFY ----------------------------------------------------
        tv = telemetry.clock_ns()
        report.fingerprint_observed = _params_fingerprint(candidate_model)
        report.verify_ms = (telemetry.clock_ns() - tv) / 1e6
        if report.fingerprint_observed != report.fingerprint_expected:
            return rollback(
                f"semantic fingerprint mismatch: expected "
                f"{report.fingerprint_expected}, observed "
                f"{report.fingerprint_observed} — candidate weights "
                "changed between prepare and cutover", "fingerprint")
        if elastic.preemption_requested():
            return rollback("preempted before shadow parity", "preempted")

        # ---- SHADOW ----------------------------------------------------
        ts = telemetry.clock_ns()
        if mode != "off":
            for payload, want in service.shadow_sample(shadow_n):
                try:
                    h = new[0].engine.submit(payload)
                    got = h.result(timeout=max(grace, 5.0))
                except Exception as e:
                    return rollback(
                        f"shadow mirror failed on the candidate: {e!r}",
                        "shadow")
                report.parity_checked += 1
                ok, diff = _parity_compare(got, want, mode, rtol, atol)
                report.parity_max_abs_diff = max(
                    report.parity_max_abs_diff, diff)
                if not ok:
                    telemetry.counter(
                        "Fleet/parity_failures",
                        labels={"service": service.name}).inc()
                    return rollback(
                        f"shadow parity violation ({mode}): candidate "
                        f"diverges from the incumbent by up to "
                        f"{diff:.3e} on mirrored live traffic",
                        "parity")
            if report.parity_checked:
                telemetry.counter(
                    "Fleet/shadow_mirrored",
                    labels={"service": service.name}).inc(
                        report.parity_checked)
            else:
                report.notes.append(
                    "no live traffic to mirror — parity vacuously clean")
        report.shadow_ms = (telemetry.clock_ns() - ts) / 1e6
        if elastic.preemption_requested():
            return rollback("preempted before cutover", "preempted")

        # ---- CUTOVER ---------------------------------------------------
        cut_ns = telemetry.clock_ns()
        old = service.cutover(new, candidate_model, report.to_version,
                              cut_ns)
        report.cutover_ns = cut_ns
        report.swap_ms = (cut_ns - t0) / 1e6
        report.promoted = True
        incident.record("fleet/cutover", service=service.name,
                        from_version=report.from_version,
                        to_version=report.to_version,
                        swap_ms=round(report.swap_ms, 2),
                        parity_checked=report.parity_checked)
        telemetry.counter("Fleet/rollouts",
                          labels={"service": service.name}).inc()
        telemetry.gauge("Fleet/swap_ms").set(report.swap_ms)
        logger.info("fleet %s: cutover %s -> %s after %.1f ms (%d "
                    "replica(s), parity %s x%d)", service.name,
                    report.from_version, report.to_version, report.swap_ms,
                    n, mode, report.parity_checked)

        # ---- DRAIN -----------------------------------------------------
        td = telemetry.clock_ns()
        for r in old:
            r.retire(grace)
        report.drain_ms = (telemetry.clock_ns() - td) / 1e6
        return report
