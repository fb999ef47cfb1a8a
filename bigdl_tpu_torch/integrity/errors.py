"""Structured errors of training-state integrity
(``bigdl_tpu/integrity/errors.py``).

The taxonomy follows how each fault heals:

- :class:`IntegrityError`: finite but wrong state on one logical copy (a
  continuity break between consecutive steps, or a checkpoint whose bytes
  verify but whose semantic fingerprint does not).  The retry loop restores
  an older valid snapshot, never retries in place, and never resets the
  retry budget for it.
- :class:`ReplicaDesyncError`: data-parallel replicas disagree on the
  bitwise parameter fingerprint.  The agreeing majority still holds the
  canonical state, so the trainer heals without a restore: it broadcasts the
  majority's parameters and replays from the first desynced iteration.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence


class IntegrityError(RuntimeError):
    """Training state failed an integrity check while every value stayed
    finite: silent data corruption, not divergence.  ``iteration`` is the
    first iteration the corruption was observed at (the step records it on
    the device, so a later read still names the onset)."""

    def __init__(self, message: str, iteration: Optional[int] = None):
        super().__init__(message)
        self.iteration = iteration


class ReplicaDesyncError(IntegrityError):
    """Data-parallel replicas disagree on the parameter fingerprint.
    ``replicas`` names the minority, ``fingerprints`` holds the gathered
    per-replica table the verdict came from, ``iteration`` the first
    iteration the disagreement was observed."""

    def __init__(self, message: str, replicas: Sequence[int] = (),
                 iteration: Optional[int] = None,
                 fingerprints: Any = None):
        super().__init__(message, iteration)
        self.replicas = tuple(int(r) for r in replicas)
        self.fingerprints = fingerprints
