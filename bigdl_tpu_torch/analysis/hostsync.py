"""Host-sync guard (``bigdl_tpu/analysis/hostsync.py``): catch implicit
device->host syncs in the trainers' hot loop.

An implicit sync -- a stray ``float(loss)``, ``.item()``, ``.cpu()``,
``if x:`` on a CUDA tensor, a ``torch.nonzero`` -- blocks the host until
the card has drained its queue, so the host can no longer enqueue the next
step's kernels while the card runs this one.  One of them inside the
per-iteration hot loop serializes the host against the card.

Two tiers, both scoped to the ARMED region on the ARMING thread, as the
JAX package scopes its guard:

- **Tier 1, on the card: ``torch.cuda.set_sync_debug_mode``**, the
  counterpart of ``jax.transfer_guard_device_to_host``.  It sees syncs that
  no conversion hook sees: ``.cpu()``, ``torch.nonzero``, boolean-mask
  indexing, ``repeat_interleave`` without an output size, a pageable
  host-to-device copy, ``Stream.synchronize``.  The mode is one setting for
  the whole process, while the guard covers one thread.  Probed on the card
  (torch 2.11, H100): in ``"warn"`` mode every synchronizing call raises a
  Python ``UserWarning`` ("called a synchronizing CUDA operation") on the
  thread that made it, at the end of the torch call that synced, and a
  warning handler that raises there makes that torch call raise -- except
  on the autograd engine's device threads, whose C++ caller swallows it;
  ``"error"`` fails every thread alike.  So tier 1 sets ``"warn"`` while it
  is held (counted; the previous mode comes back when the last holder
  lets go), puts an ``always`` filter for that message in front of
  ``warnings.filters`` for the same span, and routes the warnings by thread
  through a handler on ``warnings._showwarnmsg``.  Each armed region holds
  it, and a trainer holds it for its whole run (:meth:`HostSyncGuard.hold`),
  so its per-step regions change only thread-local state.  A sync on a
  thread inside its armed region is reported (raised in strict, counted in
  warn).  A sync on a thread the C++ runtime made (the autograd engine's
  device threads, which run the backward of a step armed on the caller's
  thread) is counted once and charged to every region armed at that
  moment: in strict each of those regions raises the
  :class:`HostSyncError` on its own thread as it ends.  Any sync outside
  every armed region -- the batch prefetcher's producers, the serving
  batcher, the watchdogs, the trainer's thread between its regions --
  fails nothing and is only counted in ``STATS.other_thread``.  When the
  caller had set the debug mode itself, every sync warning also goes on to
  its handler.  ``torch.cuda.synchronize`` raises no such warning on torch
  2.11 (probed), so tier 2 wraps it too.  ``torch.cuda.Event.synchronize``
  (the prefetcher's large-copy wait) raises none either.
- **Tier 2, everywhere: conversion hooks on ``torch.Tensor``**: the
  ``__float__`` / ``__int__`` / ``__bool__`` / ``__index__`` /
  ``__complex__`` / ``item`` / ``tolist`` / ``numpy`` / ``__array__``
  methods are wrapped once, at the first arming (never at import).  Outside
  an armed region on the arming thread they delegate unchanged; inside one
  they report the offending ``file:line`` (the first frame outside torch,
  numpy and this module) before delegating.  A region armed for the card
  (``device="cuda"``) reports conversions of CUDA tensors only: a CPU
  tensor's conversion is not a sync there.  A region armed for the CPU, or
  for no device, reports every tensor, as the JAX guard reports every
  array on its CPU backend: the CPU tests hold the same contract the card
  enforces.  A conversion that tier 2 reported does not report again as a
  tier-1 sync.

Intended pulls go through :func:`host_pull` -- the explicit choke point
(the per-iteration loss read, the serving outputs, validation) -- or an
:func:`allow_host_sync` region.  Both are counted (``STATS``), so a run can
say how many host round-trips its hot loop made.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import traceback
import warnings
from typing import Any, Optional

from bigdl_tpu_torch.analysis.lockwitness import make_lock

logger = logging.getLogger("bigdl_tpu_torch")

_TLS = threading.local()

#: the message torch's sync debug mode warns with
SYNC_MESSAGE = "called a synchronizing CUDA operation"


def _tls():
    if not hasattr(_TLS, "armed"):
        _TLS.armed = 0
        _TLS.allow = 0
        _TLS.mode = "warn"
        _TLS.device_type = None
    return _TLS


class HostSyncError(ValueError):
    """An implicit device->host sync happened inside an armed hot-loop
    region.  A ``ValueError``: a programming error the retry loop must
    surface, not retry around."""


class _Stats:
    def __init__(self):
        self.lock = make_lock("hostsync.stats")
        self.implicit = 0          # implicit syncs observed while armed
        self.explicit_pulls = 0    # host_pull calls
        self.other_thread = 0      # tier-1 syncs of threads not armed
        self.warned_sites = set()

    def snapshot(self) -> dict:
        with self.lock:
            return {"implicit": self.implicit,
                    "explicit_pulls": self.explicit_pulls,
                    "other_thread": self.other_thread}


STATS = _Stats()

_HOOK_NAMES = ("__float__", "__int__", "__index__", "__complex__",
               "__bool__", "item", "tolist", "numpy", "__array__")
_installed = {"done": False}
_INSTALL_LOCK = make_lock("hostsync.install")
#: thread ident -> mode of every thread inside an armed region
_ARMED: dict = {}
#: thread ident -> the HostSyncError an autograd device thread's sync
#: charged to that thread's strict region, raised as the region ends
_PENDING: dict = {}
#: tier 1: its holders (regions armed for the card, runs), and the state
#: it replaced
_TIER1 = {"users": 0, "prev": 0, "filter": None, "handler": None}
_TIER1_LOCK = make_lock("hostsync.tier1")

_SKIP_PARTS = ("/torch/", "/numpy/", "hostsync.py", "/warnings.py",
               "<frozen ")


def _call_site() -> str:
    """``file:line in func`` of the frame that made the conversion or the
    sync: the first frame that is not torch, numpy or this module."""
    for frame in reversed(traceback.extract_stack()):
        f = frame.filename.replace("\\", "/")
        if any(p in f for p in _SKIP_PARTS):
            continue
        return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown call site>"


def _report(op: str, arr, mode: str) -> None:
    site = _call_site()
    shape = tuple(getattr(arr, "shape", ())) if arr is not None else "?"
    dtype = (str(getattr(arr, "dtype", "?")).replace("torch.", "")
             if arr is not None else "?")
    msg = (f"implicit device->host sync via {op} on a device value "
           f"(shape={shape}, dtype={dtype}) inside the sanitized hot loop "
           f"at {site} - route intended pulls through "
           "bigdl_tpu_torch.analysis.host_pull(...) (one explicit pull) or "
           "an allow_host_sync() region; silence the pass with "
           "bigdl.analysis.hostSync=off")
    with STATS.lock:
        STATS.implicit += 1
        fresh = site not in STATS.warned_sites
        STATS.warned_sites.add(site)
    if mode == "strict":
        raise HostSyncError(msg)
    if fresh:                      # warn once per call site, count always
        logger.warning("%s", msg)


def _counts(st, tensor) -> bool:
    want = st.device_type
    if want is None:
        return True
    dev = getattr(tensor, "device", None)
    return dev is not None and dev.type == want


def _make_hook(name: str, orig):
    def hook(self, *args, **kwargs):
        st = _tls()
        if st.armed > 0 and st.allow == 0 and _counts(st, self):
            _report(name, self, st.mode)
        if st.armed == 0:
            return orig(self, *args, **kwargs)
        # a nested conversion (np.asarray -> __array__ -> numpy) and the
        # sync the conversion itself makes are this one report, not more
        st.allow += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            st.allow -= 1
    hook.__name__ = name
    hook._bigdl_hostsync_orig = orig
    return hook


def _make_sync_hook(orig):
    def synchronize(*args, **kwargs):
        st = _tls()
        if st.armed > 0 and st.allow == 0 and st.device_type != "cpu":
            _report("torch.cuda.synchronize", None, st.mode)
        return orig(*args, **kwargs)
    synchronize.__name__ = "synchronize"
    synchronize.__doc__ = orig.__doc__
    synchronize._bigdl_hostsync_orig = orig
    return synchronize


def _install_hooks() -> None:
    """Wrap the conversion methods of ``torch.Tensor`` (and
    ``torch.cuda.synchronize``), once per process, at the first arming.
    The wrappers delegate untouched unless the calling thread is inside an
    armed region: outside it a conversion pays one Python call and a
    thread-local read."""
    with _INSTALL_LOCK:
        if _installed["done"]:
            return
        import torch
        for name in _HOOK_NAMES:
            orig = getattr(torch.Tensor, name, None)
            if orig is None or hasattr(orig, "_bigdl_hostsync_orig"):
                continue
            setattr(torch.Tensor, name, _make_hook(name, orig))
        sync = torch.cuda.synchronize
        if not hasattr(sync, "_bigdl_hostsync_orig"):
            torch.cuda.synchronize = _make_sync_hook(sync)
        _installed["done"] = True


# -- tier 1 ---------------------------------------------------------------

def _is_runtime_thread() -> bool:
    """A thread the C++ runtime started (the autograd engine's device
    threads): Python sees it as a ``_DummyThread``."""
    return isinstance(threading.current_thread(), threading._DummyThread)


def _on_warning(msg) -> None:
    """``warnings._showwarnmsg`` while tier 1 is armed: a sync warning of an
    armed region is a report, one of another thread is counted; either is
    dropped when the sync debug mode is the guard's alone, and goes on to
    the previous handler when someone else had asked for the mode too.
    Every other warning goes on as before."""
    handler = _TIER1["handler"]
    if (_TIER1["users"] > 0 and isinstance(msg.message, Warning)
            and str(msg.message).startswith(SYNC_MESSAGE)):
        st = _tls()
        if st.armed > 0:
            if st.allow == 0:
                _report("a synchronizing CUDA call", None, st.mode)
        elif _is_runtime_thread() and _ARMED:
            # raising here is lost in the autograd engine's C++ caller: the
            # error waits for the strict regions' ends instead
            strict = [i for i, m in list(_ARMED.items()) if m == "strict"]
            try:
                _report("a synchronizing CUDA call (autograd device thread)",
                        None, "strict" if strict else "warn")
            except HostSyncError as e:
                for ident in strict:
                    _PENDING.setdefault(ident, e)
        else:
            with STATS.lock:
                STATS.other_thread += 1
        if _TIER1["prev"] == 0:
            return          # the mode is ours: nobody else asked for it
    handler(msg)


def _tier1_enter() -> None:
    import torch
    with _TIER1_LOCK:
        if _TIER1["users"] == 0:
            if _TIER1["handler"] is None:
                _TIER1["handler"] = warnings._showwarnmsg
                warnings._showwarnmsg = _on_warning
            _TIER1["prev"] = torch.cuda.get_sync_debug_mode()
            warnings.filterwarnings("always", message=SYNC_MESSAGE,
                                    category=UserWarning)
            _TIER1["filter"] = warnings.filters[0]
            torch.cuda.set_sync_debug_mode("warn")
        _TIER1["users"] += 1


def _tier1_exit() -> None:
    import torch
    with _TIER1_LOCK:
        _TIER1["users"] -= 1
        if _TIER1["users"] > 0:
            return
        torch.cuda.set_sync_debug_mode(_TIER1["prev"])
        entry, _TIER1["filter"] = _TIER1["filter"], None
        if entry in warnings.filters:
            warnings.filters.remove(entry)
            warnings._filters_mutated()


# -- the public surface -----------------------------------------------------

@contextlib.contextmanager
def allow_host_sync():
    """Permit device->host syncs inside an armed region (the escape hatch
    for code that cannot batch through :func:`host_pull`)."""
    st = _tls()
    st.allow += 1
    try:
        yield
    finally:
        st.allow -= 1


def _to_host(x, cuda_devices: set):
    import numpy as np
    import torch
    if isinstance(x, dict):
        return {k: _to_host(v, cuda_devices) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v, cuda_devices) for v in x)
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type == "cuda":
            cuda_devices.add(t.device)
            t = t.to("cpu", non_blocking=True)
        return t
    if isinstance(x, np.generic):
        return np.asarray(x)
    return x


def _numpy_leaves(x):
    import torch
    if isinstance(x, dict):
        return {k: _numpy_leaves(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy_leaves(v) for v in x)
    if isinstance(x, torch.Tensor):
        try:
            return x.numpy()
        except TypeError:       # a dtype numpy has not (bfloat16)
            return x
    return x


def host_pull(x: Any, what: str = "") -> Any:
    """The explicit device->host choke point: the whole (possibly nested)
    value comes to the host in one round trip -- one tensor is copied with
    ``.cpu()``; in a tree every CUDA tensor is copied with
    ``non_blocking=True``, then each device's current stream is
    synchronized once -- permitted inside armed regions and counted.
    Tensors come back as numpy arrays (a dtype numpy lacks, bfloat16, as a
    CPU tensor), as ``jax.device_get`` gives numpy arrays."""
    st = _tls()
    st.allow += 1
    try:
        import torch
        if isinstance(x, torch.Tensor):
            out = x.detach().cpu()      # one tensor: one synchronous copy
        else:
            devices: set = set()
            out = _to_host(x, devices)
            for d in devices:
                torch.cuda.current_stream(d).synchronize()
        out = _numpy_leaves(out)
    finally:
        st.allow -= 1
    with STATS.lock:
        STATS.explicit_pulls += 1
    return out


def _device_type(device) -> Optional[str]:
    if device is None:
        return None
    return getattr(device, "type", None) or str(device).split(":")[0]


class HostSyncGuard:
    """Arms the host-sync pass around a hot-loop region.

    ``with guard.armed(): ...`` -- inside, implicit device->host syncs on
    THIS thread raise :class:`HostSyncError` (strict) or log once per site
    and count (warn).  ``device`` is the device the region's work runs on:
    ``"cuda"`` arms both tiers and reports CUDA tensors' conversions; the
    CPU or None arms tier 2 over every tensor.  :meth:`from_config` reads
    ``bigdl.analysis.hostSync``; a disabled config gives
    :data:`NULL_GUARD`, whose ``armed()`` is free."""

    def __init__(self, mode: str = "warn", device=None):
        self.mode = mode
        self.device_type = _device_type(device)
        self.enabled = mode in ("strict", "warn")

    @classmethod
    def from_config(cls, device=None) -> "HostSyncGuard":
        from bigdl_tpu_torch.analysis import pass_mode
        mode = pass_mode("hostSync")
        if mode == "off":
            return NULL_GUARD
        return cls(mode, device=device)

    def _tier1(self) -> bool:
        if self.device_type != "cuda":
            return False
        import torch
        return torch.cuda.is_available()

    @contextlib.contextmanager
    def hold(self):
        """Hold tier 1 (the sync debug mode, its warning filter and
        handler) and the hooks for a whole run, so that the run's armed
        regions switch only thread-local state.  Reports nothing itself:
        a sync outside every armed region is only counted."""
        if not (self.enabled and self._tier1()):
            yield
            return
        _install_hooks()
        _tier1_enter()
        try:
            yield
        finally:
            _tier1_exit()

    @contextlib.contextmanager
    def armed(self):
        if not self.enabled:
            yield
            return
        _install_hooks()
        st = _tls()
        prev = (st.mode, st.device_type)
        tier1 = self._tier1()
        if tier1:
            _tier1_enter()
        st.mode, st.device_type = self.mode, self.device_type
        st.armed += 1
        ident = threading.get_ident()
        outer = _ARMED.get(ident)
        _ARMED[ident] = self.mode
        try:
            yield
        finally:
            st.armed -= 1
            st.mode, st.device_type = prev
            if outer is None:
                _ARMED.pop(ident, None)
            else:
                _ARMED[ident] = outer
            pending = _PENDING.pop(ident, None) if outer is None else None
            if tier1:
                _tier1_exit()
        if pending is not None:
            raise pending

    @property
    def implicit_syncs(self) -> int:
        return STATS.snapshot()["implicit"]


class _NullGuard(HostSyncGuard):
    def __init__(self):
        self.mode = "off"
        self.device_type = None
        self.enabled = False


NULL_GUARD = _NullGuard()
