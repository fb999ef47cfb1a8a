"""Runtime lock-order witness (``bigdl_tpu/analysis/lockwitness.py``): the
dynamic half of the concurrency pass.

Every lock the port's threads own is born through the factory here --
:func:`make_lock` / :func:`make_rlock` / :func:`make_condition` -- instead
of a raw ``threading.Lock()``, under the name its JAX counterpart gives it
(``serving.engine``, ``lm.stream``, ``governor.account``, ...).  A name is
a lock *class*: every ``governor.account`` lock shares one node.  When the
witness is armed, the acquire path does what TSan's deadlock detector does
at run time:

- it keeps the per-thread **held-lock stack** (thread-local);
- on every acquisition made while other locks are held, it adds the
  ``held -> acquiring`` edges to one process-wide **acquisition-order
  graph**, keeping the first witnessing site and stack of each edge;
- **before blocking** on the underlying lock, it checks whether the new
  edge closes a cycle in that graph -- two call paths that take the same
  locks in opposite orders CAN deadlock, whether or not they did this run
  -- and raises a structured :class:`LockOrderViolation` naming both sites
  and both stacks (strict) or logs it once per edge pair (warn).

The check runs before the blocking acquire: a witness that spoke only
after the acquire would be silent exactly when the deadlock it reports had
already wedged both threads.  Disarmed (``bigdl.analysis.lockWitness``
off, the default), every wrapper method is one bool check and a delegate.

``bigdl.chaos.lockDelayAt="<lockname>:k[:seconds]"`` hooks this acquire
path: the k-th acquisition of the named lock, counted from the chaos plan's
``install()``, stalls for ``seconds`` (default 0.05) just after the order
check, widening a racy window on demand (once per position per plan; only
while the witness is armed).

The witness's own lock is a raw ``threading.Lock``: the graph's guard
cannot route through the factory it implements.
"""

from __future__ import annotations

import logging
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

logger = logging.getLogger("bigdl_tpu_torch")

_MODES = ("strict", "warn", "off")

_TLS = threading.local()

_CHAOS_MOD = None


def _chaos():
    """The chaos module, bound once on first armed acquire — a module
    global beats re-running the import machinery on the hot path."""
    global _CHAOS_MOD
    if _CHAOS_MOD is None:
        from bigdl_tpu_torch.utils import chaos
        _CHAOS_MOD = chaos
    return _CHAOS_MOD


def _tls():
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


class LockOrderViolation(RuntimeError):
    """A lock acquisition that closes a cycle in the global
    acquisition-order graph: two call paths take the same locks in
    opposite orders and can deadlock.

    Structured fields (the message carries all of them too):

    - ``edge``: the ``(held, acquiring)`` name pair being added
    - ``reverse_edge``: the previously-recorded conflicting pair
    - ``site`` / ``reverse_site``: ``file:line in func`` of each
      witnessing acquisition
    - ``stack`` / ``reverse_stack``: the full stacks of both
      acquisitions (this thread now; the first witness of the reverse
      edge then)
    """

    def __init__(self, message: str, *, edge: Tuple[str, str],
                 reverse_edge: Tuple[str, str], site: str,
                 reverse_site: str, stack: str, reverse_stack: str):
        super().__init__(message)
        self.edge = edge
        self.reverse_edge = reverse_edge
        self.site = site
        self.reverse_site = reverse_site
        self.stack = stack
        self.reverse_stack = reverse_stack


def _call_site() -> str:
    """``file:line in func`` of the acquiring frame — the first frame
    below this module (the wrapper internals are never the news)."""
    for frame in reversed(traceback.extract_stack()):
        if frame.filename.endswith("lockwitness.py"):
            continue
        return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown call site>"


def _stack() -> str:
    frames = [f for f in traceback.extract_stack()
              if not f.filename.endswith("lockwitness.py")]
    return "".join(traceback.format_list(frames))


class _Witness:
    """The process-wide acquisition-order graph + counters.  ``mode`` is
    flipped by :func:`arm`/:func:`disarm`; every wrapper fast-paths on
    it with a single attribute read."""

    def __init__(self):
        self.mode = "off"
        # raw by design: the graph guard cannot route through the
        # factory it implements
        self._lock = threading.Lock()
        #: outer name -> inner names acquired while outer was held
        self.graph: Dict[str, Set[str]] = {}
        #: (outer, inner) -> (site, stack) of the first witnessing acquire
        self.edge_sites: Dict[Tuple[str, str], Tuple[str, str]] = {}
        #: per-name acquisition counters for the ONE lock an armed
        #: chaos lockDelayAt plan targets (exact, locked); all other
        #: names never enter this dict
        self.name_counts: Dict[str, int] = {}
        #: every name witnessed at least once (unlocked; GIL-atomic add)
        self.names: Set[str] = set()
        #: witness-lock name an armed chaos lockDelayAt plan targets
        #: (pushed by chaos.install/uninstall) — one attribute compare
        #: on the hot path instead of a chaos probe per acquisition
        self.chaos_target: Optional[str] = None
        self.acquires = 0
        self.violations = 0
        self._warned: Set[Tuple[str, str]] = set()
        #: arming generation: bumped by arm(); per-thread held stacks
        #: tagged with an older generation are stale (their locks were
        #: released while the witness was off) and get dropped lazily
        self.gen = 0

    # -- graph -----------------------------------------------------------

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A directed path src -> ... -> dst in the current graph, or
        None.  Iterative DFS; the graph is dozens of nodes, not
        thousands."""
        if src == dst:
            return [src]
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self.graph.get(node, ()):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def record_edge(self, outer: str, inner: str
                    ) -> Optional[LockOrderViolation]:
        """Add ``outer -> inner``; returns the violation when the edge
        closes a cycle (caller raises/logs per mode).  Site/stack capture
        happens only for NEW edges, so steady-state cost is one dict
        probe under the witness lock."""
        with self._lock:
            known = self.graph.get(outer)
            if known is not None and inner in known:
                return None
            cycle = self._path(inner, outer)
            self.graph.setdefault(outer, set()).add(inner)
            site, stack = _call_site(), _stack()
            self.edge_sites[(outer, inner)] = (site, stack)
            if cycle is None:
                return None
            self.violations += 1
            # the first edge of the recorded reverse path is the other
            # half of the inversion: inner -> ... -> outer
            rev = (cycle[0], cycle[1])
            rev_site, rev_stack = self.edge_sites.get(
                rev, ("<unknown>", "<no stack recorded>"))
        chain = " -> ".join(cycle)
        msg = (
            f"lock-order inversion: acquiring {inner!r} while holding "
            f"{outer!r} at {site}, but the acquisition-order graph "
            f"already records {chain} -> {outer} (edge {rev[0]!r} -> "
            f"{rev[1]!r} first witnessed at {rev_site}) — two threads "
            f"taking these paths concurrently can deadlock.\n"
            f"--- this acquisition ({outer} -> {inner}) ---\n{stack}"
            f"--- prior acquisition ({rev[0]} -> {rev[1]}) ---\n"
            f"{rev_stack}")
        return LockOrderViolation(
            msg, edge=(outer, inner), reverse_edge=rev, site=site,
            reverse_site=rev_site, stack=stack, reverse_stack=rev_stack)

    # -- acquire/release hooks ------------------------------------------

    def scan_held(self, lock: "WitnessLock", held: list) -> None:
        """The nested-acquisition path (something else already held):
        record ``held -> acquiring`` edges, raise/log on a cycle."""
        if any(h is lock for h in held):       # reentrant: no new edges
            return
        for h in held:
            if h.name == lock.name:
                continue   # same lock class nested: no self-edges
            violation = self.record_edge(h.name, lock.name)
            if violation is not None:
                if self.mode == "strict":
                    raise violation
                pair = tuple(sorted(violation.edge))
                with self._lock:
                    fresh = pair not in self._warned
                    self._warned.add(pair)
                if fresh:
                    logger.warning("%s", violation)

    def chaos_delay(self, lock: "WitnessLock") -> None:
        """The chaos-targeted path: per-name exact counting (the plan's
        k counts acquisitions since the plan was armed) + the stall."""
        with self._lock:
            n = self.name_counts.get(lock.name, 0) + 1
            self.name_counts[lock.name] = n
        delay = _chaos().lock_delay(lock.name, n)
        if delay > 0:
            import time
            time.sleep(delay)

    # -- introspection ----------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "mode": self.mode,
                "acquires": self.acquires,
                "locks": len(self.names),
                "edges": sum(len(v) for v in self.graph.values()),
                "violations": self.violations,
            }

    def reset(self) -> None:
        with self._lock:
            self.graph.clear()
            self.edge_sites.clear()
            self.name_counts.clear()
            self.names.clear()
            self.acquires = 0
            self.violations = 0
            self._warned.clear()


_WITNESS = _Witness()


class WitnessLock:
    """Factory lock: a named wrapper over a raw ``threading.Lock`` /
    ``RLock``.  Disarmed, every method is one mode check + delegate;
    armed, the acquire path runs the witness (see module doc)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, raw):
        self.name = name
        self._lock = raw

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        w = _WITNESS
        if w.mode == "off":
            return self._lock.acquire(blocking, timeout)
        # armed fast path, inlined flat: counters are unlocked on purpose
        # (a lost increment under the GIL is telemetry drift; the graph
        # itself stays guarded — record_edge takes the witness lock) and
        # the nested/chaos branches are out-of-line — an uncontended
        # leaf acquire pays attribute reads, not function calls
        held = getattr(_TLS, "held", None)
        if held is None:
            held = _TLS.held = []
        if getattr(_TLS, "gen", -1) != w.gen:
            del held[:]                 # stale entries from a prior window
            _TLS.gen = w.gen
        w.acquires += 1
        w.names.add(self.name)                 # set.add is GIL-atomic
        if held:
            w.scan_held(self, held)     # may raise LockOrderViolation
        if w.chaos_target is not None and w.chaos_target == self.name:
            w.chaos_delay(self)
        got = self._lock.acquire(blocking, timeout)
        if got:
            held.append(self)
        return got

    def release(self) -> None:
        self._lock.release()
        if _WITNESS.mode != "off":
            held = getattr(_TLS, "held", None)
            if held:                 # disarmed-acquired: nothing tracked
                for i in range(len(held) - 1, -1, -1):
                    if held[i] is self:
                        del held[i]
                        break

    def __enter__(self) -> bool:
        if _WITNESS.mode == "off":     # skip the wrapper layer entirely
            return self._lock.acquire()
        return self.acquire()

    def __exit__(self, *exc) -> None:
        if _WITNESS.mode == "off":
            self._lock.release()
            return
        self.release()

    def locked(self) -> bool:
        fn = getattr(self._lock, "locked", None)
        return bool(fn()) if fn is not None else False

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name!r} over {self._lock!r}>"


def make_lock(name: str) -> WitnessLock:
    """A named, witnessed mutual-exclusion lock — the factory every
    threaded module routes ``threading.Lock()`` through."""
    return WitnessLock(name, threading.Lock())


def make_rlock(name: str) -> WitnessLock:
    """A named, witnessed reentrant lock.  Reentrant acquisitions are
    recognized by object identity on the held stack and add no edges."""
    return WitnessLock(name, threading.RLock())


def make_condition(name: str) -> threading.Condition:
    """A condition variable over a witnessed (non-reentrant) factory
    lock.  ``wait()`` releases and re-acquires through the wrapper, so
    the held-lock stack stays truthful across waits.  Always a plain
    underlying Lock: ``threading.Condition``'s ownership probe
    (``acquire(False)``) is only correct for non-reentrant locks."""
    return threading.Condition(make_lock(name))


# ---------------------------------------------------------------------------
# arming (the port tests' autouse fixture's surface)
# ---------------------------------------------------------------------------

def arm(mode: Optional[str] = None) -> str:
    """Arm the witness: ``strict`` raises :class:`LockOrderViolation` on
    any cycle, ``warn`` logs once per edge pair and counts.  ``mode``
    None resolves ``bigdl.analysis.lockWitness`` (default ``off``).
    Returns the effective mode."""
    if mode is None:
        from bigdl_tpu_torch.analysis import pass_mode
        mode = pass_mode("lockWitness", default="off")
    if mode not in _MODES:
        logger.warning("lockwitness: unknown mode %r — staying off", mode)
        mode = "off"
    if _WITNESS.mode == "off" and mode != "off":
        _WITNESS.gen += 1        # new arming window: stale held entries
        #                          (released while off) must not survive
    _WITNESS.mode = mode
    return mode


def set_chaos_delay_target(name: Optional[str]) -> None:
    """Called by ``chaos.install``/``uninstall``: the witness lock name
    an armed ``bigdl.chaos.lockDelayAt`` plan targets (None to clear)."""
    _WITNESS.chaos_target = name


def disarm() -> None:
    """Back to free-running (plain delegation); the recorded graph is
    kept — call :func:`reset` for test isolation."""
    _WITNESS.mode = "off"


def armed() -> str:
    return _WITNESS.mode


def snapshot() -> dict:
    """Witness counters: acquires, distinct locks, edges, violations."""
    return _WITNESS.snapshot()


def reset() -> None:
    """Drop the acquisition-order graph and all counters (test
    isolation between arming windows)."""
    _WITNESS.reset()


def order_graph() -> Dict[str, Set[str]]:
    """A copy of the current acquisition-order graph (diagnostics)."""
    with _WITNESS._lock:
        return {k: set(v) for k, v in _WITNESS.graph.items()}
