"""The runtime analysis passes of the port (``bigdl_tpu/analysis``).

The JAX package turns three classic failure modes of a training stack into
standing checks; the port keeps them, each held against its JAX twin on the
CPU:

1. **Recompile sentinel** (:mod:`~bigdl_tpu_torch.analysis.retrace`): the
   abstract signature (shapes and dtypes) of every call of a trainer's step
   and a serving engine's forward; after warmup an unseen signature raises
   (strict) or logs a per-leaf diff (warn), charted as
   ``Analysis/retraces``.  In eager PyTorch such a call compiles nothing,
   but the card plans again (a cuDNN autotune, a cuBLAS plan, the LM
   decode graph's recapture).
2. **Host-sync guard** (:mod:`~bigdl_tpu_torch.analysis.hostsync`): a
   context manager around the trainers' hot loop.  On the card,
   ``torch.cuda.set_sync_debug_mode`` reports every synchronizing CUDA
   call of the armed thread; everywhere, hooks on ``torch.Tensor``'s
   conversions (``float()``, ``.item()``, ``.numpy()``, ...) report the
   offending ``file:line``.  Intended pulls go through :func:`host_pull`.
3. **Module contract checker** (:mod:`~bigdl_tpu_torch.analysis.contracts`):
   a module may declare the input ranks and dtypes it takes;
   :func:`check_model` walks a model over ``meta`` tensors (zero FLOPs, no
   kernel on the card) and reports contract violations, promotion drift
   and NCHW ops inside an NHWC region.
4. **Lock-order witness** (:mod:`~bigdl_tpu_torch.analysis.lockwitness`):
   the port's locks are born through :func:`make_lock` /
   :func:`make_rlock` / :func:`make_condition`; armed, an acquisition that
   closes a cycle in the process-wide acquisition-order graph raises
   :class:`LockOrderViolation` before it blocks.

The JAX package's static passes (``lint.py``, ``concurrency.py``,
``hlo_audit.py``, ``program_contracts.py``) are not ported.

Modes per pass (``bigdl.analysis.*`` in ``utils/config.py``): ``strict``
(raise), ``warn`` (log + count), ``off``.
"""

from __future__ import annotations

from bigdl_tpu_torch.utils import config as _config

_MODES = ("strict", "warn", "off")


def pass_mode(key: str, default: str = "warn") -> str:
    """Resolve a pass's mode from ``bigdl.analysis.<key>``; an unknown value
    degrades to ``off`` rather than crashing a training run over a typo
    (the typo is still loud: it is logged once)."""
    mode = str(_config.get_property(f"bigdl.analysis.{key}", default)).lower()
    if mode not in _MODES:
        if (key, mode) not in _WARNED:
            _WARNED.add((key, mode))
            import logging
            logging.getLogger("bigdl_tpu_torch").warning(
                "bigdl.analysis.%s=%r is not one of %s - pass disabled",
                key, mode, _MODES)
        return "off"
    return mode


_WARNED: set = set()

from bigdl_tpu_torch.analysis.retrace import (RetraceError,  # noqa: E402
                                              RetraceSentinel,
                                              abstract_signature)
from bigdl_tpu_torch.analysis.hostsync import (HostSyncError,  # noqa: E402
                                               HostSyncGuard,
                                               allow_host_sync, host_pull)
from bigdl_tpu_torch.analysis.contracts import (ContractError,  # noqa: E402
                                                ContractReport,
                                                ModuleContract, check_model)
from bigdl_tpu_torch.analysis.lockwitness import (  # noqa: E402
    LockOrderViolation, make_condition, make_lock, make_rlock)

__all__ = [
    "pass_mode",
    "RetraceError", "RetraceSentinel", "abstract_signature",
    "HostSyncError", "HostSyncGuard", "allow_host_sync", "host_pull",
    "ContractError", "ContractReport", "ModuleContract", "check_model",
    "LockOrderViolation", "make_lock", "make_rlock", "make_condition",
]
