"""Host-memory governor: byte accounting and soft-budget backpressure
(``bigdl_tpu/resources/governor.py``: ``Account`` :37, ``HostMemoryGovernor``
:62, ``poll`` :124, ``check_item`` :170, ``item_nbytes`` :206, the registry
provider :230).

Every bounded host buffer registers an :class:`Account` here and keeps it
current as items enter and leave; in the port that is the trainers' batch
prefetcher, whose pinned staging slots and queued batches are the
``prefetch_slots`` account (:class:`~bigdl_tpu_torch.engine.
BatchPrefetcher`).  The roll-up is exported as ``Resources/host_bytes``
through the telemetry registry's provider mechanism, one gauge per account
plus the total.

A soft budget ``bigdl.resources.hostMemBudgetMB`` (0 = accounting only)
turns the governor active: when the accounted total reaches the budget, or
the chaos injector ``bigdl.chaos.hostMemPressureAt`` clamps the reported
free bytes at the k-th poll, the registered *shrinkers* fire (the
prefetcher halves its read-ahead depth).  Shrinks persist for the rest of
the run; pressure detection is edge-triggered, so a sustained breach fires
the shrinkers once per excursion.  When one item exceeds the whole budget
there is no depth left to shrink: :meth:`HostMemoryGovernor.check_item`
raises :class:`~bigdl_tpu_torch.resources.errors.HostMemoryError`, which the
trainers' retry loop treats as fatal.

The registry provider is registered at the governor's first use, not at
import, and again after a registry reset.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Iterable, Tuple

from bigdl_tpu_torch.resources.errors import HostMemoryError

logger = logging.getLogger("bigdl_tpu_torch")


class Account:
    """One named byte ledger.  Thread-safe; clamped at zero, so a stray
    double subtraction cannot go negative."""

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def add(self, n: int) -> None:
        with self._lock:
            self._bytes += max(0, int(n))

    def sub(self, n: int) -> None:
        with self._lock:
            self._bytes = max(0, self._bytes - max(0, int(n)))

    def set(self, n: int) -> None:
        with self._lock:
            self._bytes = max(0, int(n))


class HostMemoryGovernor:
    """Process-wide ledger of accounted host buffers, the soft-budget
    reaction (shrinkers) and the hard escalation (HostMemoryError)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._accounts: Dict[str, Account] = {}
        self._shrinkers: Dict[str, Callable[[], None]] = {}
        self._polls = 0
        self._pressure_events = 0
        self._under_pressure = False

    # ---- accounts ------------------------------------------------------

    def account(self, name: str) -> Account:
        """Get or create the named ledger."""
        _register_provider()
        with self._lock:
            acct = self._accounts.get(name)
            if acct is None:
                acct = self._accounts[name] = Account(name,
                                                      threading.Lock())
        return acct

    def total_bytes(self) -> int:
        with self._lock:
            accounts = list(self._accounts.values())
        return sum(a.nbytes for a in accounts)

    def budget_bytes(self) -> int:
        """The soft budget in bytes (0 = accounting only)."""
        from bigdl_tpu_torch.utils import config
        mb = config.get_float("bigdl.resources.hostMemBudgetMB", 0.0)
        return int(mb * (1 << 20)) if mb > 0 else 0

    def free_bytes(self) -> int:
        """Budget headroom (a large sentinel without a budget): the value
        the chaos injector clamps."""
        budget = self.budget_bytes()
        if budget <= 0:
            return 1 << 62
        return budget - self.total_bytes()

    # ---- budget reaction -----------------------------------------------

    def register_shrinker(self, name: str, fn: Callable[[], None]) -> None:
        """Register a depth-reduction callback; unregister on teardown."""
        with self._lock:
            self._shrinkers[name] = fn

    def unregister_shrinker(self, name: str) -> None:
        with self._lock:
            self._shrinkers.pop(name, None)

    def poll(self) -> bool:
        """One governor tick (the trainers' loop calls it once an
        iteration).  True when a pressure excursion fired the shrinkers
        this tick."""
        from bigdl_tpu_torch.utils import chaos
        _register_provider()
        with self._lock:
            self._polls += 1
            polls = self._polls
        free = self.free_bytes()
        if chaos.host_mem_pressure(polls):
            free = 0    # injected pressure: the headroom vanishes
        under = free <= 0
        fired = False
        with self._lock:
            if under and not self._under_pressure:
                fired = True
                self._pressure_events += 1
            self._under_pressure = under
            shrinkers = list(self._shrinkers.items()) if fired else []
        if fired:
            from bigdl_tpu_torch import telemetry
            telemetry.counter(
                "Resources/host_pressure",
                help="host-memory pressure excursions (budget or "
                     "injected) that fired the shrinkers").inc()
            telemetry.incident.record(
                "governor/shrink", accounted_bytes=self.total_bytes(),
                budget_bytes=self.budget_bytes(),
                shrinkers=[name for name, _ in shrinkers])
            logger.warning(
                "host-memory pressure: %d B accounted vs %d B budget - "
                "shrinking %d registered buffer(s)", self.total_bytes(),
                self.budget_bytes(), len(shrinkers))
            for name, fn in shrinkers:
                try:
                    fn()
                except Exception as e:   # a broken shrinker must not
                    logger.warning(      # take the training loop down
                        "resource shrinker %r failed: %r", name, e)
        return fired

    def under_pressure(self) -> bool:
        with self._lock:
            return self._under_pressure

    def check_item(self, name: str, nbytes: int) -> None:
        """Raise :class:`HostMemoryError` when ONE item is larger than the
        whole budget: depth shrinking bottoms out at 1."""
        budget = self.budget_bytes()
        if budget > 0 and int(nbytes) > budget:
            from bigdl_tpu_torch import telemetry
            telemetry.counter(
                "Resources/host_budget_exceeded",
                help="single-item host-memory budget escalations").inc()
            raise HostMemoryError(name, int(nbytes), budget)

    # ---- telemetry / lifecycle -----------------------------------------

    def summary_scalars(self) -> Iterable[Tuple[str, float]]:
        yield ("Resources/host_bytes", float(self.total_bytes()))
        with self._lock:
            accounts = list(self._accounts.values())
            events = self._pressure_events
        for a in accounts:
            yield (f"Resources/host_bytes_{a.name}", float(a.nbytes))
        yield ("Resources/host_pressure_events", float(events))

    def reset(self) -> None:
        """Drop every account, shrinker and counter (test isolation)."""
        with self._lock:
            self._accounts.clear()
            self._shrinkers.clear()
            self._polls = 0
            self._pressure_events = 0
            self._under_pressure = False


#: the process-wide governor every accounted buffer reports to
GOVERNOR = HostMemoryGovernor()


def item_nbytes(obj, _depth: int = 0) -> int:
    """Host-byte estimate of one buffered item: arrays and tensors report
    their bytes, bytes-likes their length, containers the sum of their
    members (depth-capped)."""
    if obj is None or _depth > 3:
        return 0
    if hasattr(obj, "element_size") and hasattr(obj, "numel"):
        return int(obj.numel() * obj.element_size())
    n = getattr(obj, "nbytes", None)
    if n is not None:
        try:
            return int(n)
        except (TypeError, ValueError):
            return 0
    if isinstance(obj, (bytes, bytearray, memoryview, str)):
        return len(obj)
    if isinstance(obj, dict):
        return sum(item_nbytes(v, _depth + 1) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(item_nbytes(v, _depth + 1) for v in obj)
    return 0


def _register_provider() -> None:
    """Put the governor's roll-up into the telemetry registry (idempotent;
    a registry reset drops it, the next use puts it back)."""
    from bigdl_tpu_torch import telemetry
    reg = telemetry.REGISTRY
    if reg._providers.get("resources") != GOVERNOR.summary_scalars:
        reg.register_provider("resources", GOVERNOR.summary_scalars)
