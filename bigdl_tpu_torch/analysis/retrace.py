"""Recompile sentinel (``bigdl_tpu/analysis/retrace.py``): catch silent
signature drift of a step function.

The JAX package's fused step recompiles whenever the abstract signature of
its arguments changes -- a shape drift from an uneven batch, a dtype flip
from a dropped cast -- and each retrace costs seconds of XLA compile.  The
port's steps are eager PyTorch, so an unseen signature compiles nothing;
but the card still plans again: cuDNN autotunes a new convolution shape
(under ``cudnn.benchmark``), cuBLAS picks a new GEMM plan, the caching
allocator carves new blocks, and ``LMServingEngine``'s decode step, a CUDA
graph captured at one shape, would have to be captured again.  A step that
sees a new signature every iteration runs that planning every iteration.

The sentinel keys every call of a wrapped function by its abstract
signature: the argument tree's structure and, per leaf, its shape and
dtype.  Dtypes are printed under numpy's names (``float32``, ``bfloat16``,
``int64``), so the diff lines read as the JAX package's do.  A tensor has
no weak type; a Python scalar keeps the JAX rule (weak, keyed by its type,
not its value).  New signatures during warmup are plans and are budgeted
(``bigdl.analysis.retraceBudget``); after warmup
(``bigdl.analysis.retraceWarmupSteps`` calls) an unseen signature is a
retrace: ``strict`` raises :class:`RetraceError` with a per-leaf diff
against the previous signature, ``warn`` logs the same diff and counts it
(``Analysis/retraces`` in TrainSummary).

Keying reads host metadata only (no device sync).
"""

from __future__ import annotations

import logging
from typing import Any, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.utils import config

logger = logging.getLogger("bigdl_tpu_torch")


class RetraceError(ValueError):
    """A wrapped step was called with an unseen abstract signature after
    warmup.  A ``ValueError``: the trainer's retry loop treats it as a
    programming error (retrying would plan again) instead of restoring a
    snapshot and looping."""


def _dtype_name(dtype) -> str:
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


def _is_array(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype") and \
        not isinstance(x, (bool, int, float, complex))


def _leaf_sig(x) -> Tuple:
    """(shape, dtype, weak_type) of one argument leaf."""
    if _is_array(x):
        # torch.Tensor, np.ndarray, or a (shape, dtype) stand-in
        return (tuple(int(d) for d in x.shape), _dtype_name(x.dtype), False)
    if isinstance(x, (bool, int, float, complex)):
        # Python scalars: the VALUE does not change the signature, the TYPE
        # does (the JAX rule for weak-typed 0-d values)
        return ((), type(x).__name__, True)
    # any other leaf (a string, None, ...) is static: identity by repr
    return ("static", repr(x)[:120], False)


def _flatten(x, path: str, leaves: List, paths: List[str]):
    """The tree structure of ``x`` (tuples, lists and dicts, dict keys
    sorted as JAX sorts them) with its leaves and their paths appended."""
    if isinstance(x, dict):
        keys = sorted(x)
        return ("dict", tuple(keys), tuple(
            _flatten(x[k], f"{path}[{k!r}]", leaves, paths) for k in keys))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, len(x), tuple(
            _flatten(v, f"{path}[{i}]", leaves, paths)
            for i, v in enumerate(x)))
    if x is None:
        return ("none",)
    leaves.append(x)
    paths.append(path)
    return "*"


def _treedef_str(td) -> str:
    if td == "*":
        return "*"
    kind = td[0]
    if kind == "none":
        return "None"
    if kind == "dict":
        inner = ", ".join(f"{k!r}: {_treedef_str(c)}"
                          for k, c in zip(td[1], td[2]))
        return "{" + inner + "}"
    inner = ", ".join(_treedef_str(c) for c in td[2])
    if kind == "tuple":
        return "(" + inner + ("," if len(td[2]) == 1 else "") + ")"
    return "[" + inner + "]"


class TreeDef:
    """The structure of an argument tree; equal trees compare equal, and
    it prints as JAX's ``PyTreeDef`` does."""

    __slots__ = ("td",)

    def __init__(self, td):
        self.td = td

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self.td == other.td

    def __hash__(self) -> int:
        return hash(self.td)

    def __repr__(self) -> str:
        return f"PyTreeDef({_treedef_str(self.td)})"


def _flatten_args(args) -> Tuple[TreeDef, List, List[str]]:
    leaves: List = []
    paths: List[str] = []
    td = _flatten(args, "", leaves, paths)
    return TreeDef(td), leaves, paths


def abstract_signature(args: Tuple) -> Tuple[Any, Tuple]:
    """(tree structure, per-leaf signature tuple) for a call's arguments:
    equal signatures are one plan."""
    td, leaves, _ = _flatten_args(args)
    return td, tuple(_leaf_sig(x) for x in leaves)


def _signature_paths(args: Tuple) -> List[str]:
    """A readable path per leaf (``[3]``, ``[5]['lr']``), aligned with the
    signature tuple."""
    return _flatten_args(args)[2]


def signature_diff(old: Tuple, new: Tuple, paths: List[str]) -> List[str]:
    """Per-leaf delta lines between two signatures (shape / dtype /
    weak-type changes named explicitly)."""
    old_td, old_sig = old
    new_td, new_sig = new
    lines: List[str] = []
    if old_td != new_td:
        lines.append(f"argument tree structure changed: {old_td} -> {new_td}")
    n = min(len(old_sig), len(new_sig))
    for i in range(n):
        o, nw = old_sig[i], new_sig[i]
        if o == nw:
            continue
        what = []
        if o[0] != nw[0]:
            what.append("shape")
        if o[1] != nw[1]:
            what.append("dtype")
        if o[2] != nw[2]:
            what.append("weak-type")
        path = paths[i] if i < len(paths) else f"leaf[{i}]"
        lines.append(
            f"  {path}: {o[0]} {o[1]}{' weak' if o[2] else ''} -> "
            f"{nw[0]} {nw[1]}{' weak' if nw[2] else ''} "
            f"[{', '.join(what) or 'static'}]")
    if len(old_sig) != len(new_sig):
        lines.append(f"  leaf count changed: {len(old_sig)} -> {len(new_sig)}")
    return lines


class RetraceSentinel:
    """Signature tracking around one step function.

    ``wrap(fn)`` returns a callable that behaves as ``fn`` and keeps the
    books: ``calls``, ``retraces`` (post-warmup events),
    ``compiles_in_warmup`` and ``last_diff`` (the delta of the most recent
    event).
    """

    def __init__(self, name: str, mode: Optional[str] = None,
                 warmup_steps: Optional[int] = None,
                 budget: Optional[int] = None):
        from bigdl_tpu_torch.analysis import pass_mode
        self.name = name
        self.mode = mode if mode is not None else pass_mode("retrace")
        self.warmup_steps = (
            warmup_steps if warmup_steps is not None else
            config.get_int("bigdl.analysis.retraceWarmupSteps", 2))
        self.budget = (budget if budget is not None else
                       config.get_int("bigdl.analysis.retraceBudget", 2))
        self.calls = 0
        self.retraces = 0
        self.compiles_in_warmup = 0
        self._seen = {}            # signature -> first-seen call number
        self._last = None          # last signature
        self._last_args_paths: List[str] = []
        self.last_diff: List[str] = []

    @classmethod
    def from_config(cls, name: str) -> Optional["RetraceSentinel"]:
        from bigdl_tpu_torch.analysis import pass_mode
        mode = pass_mode("retrace")
        if mode == "off":
            return None
        return cls(name, mode=mode)

    # -- observation ------------------------------------------------------

    def observe(self, args: Tuple) -> Optional[List[str]]:
        """Record one call.  Returns the diff when the call is a post-warmup
        retrace (or a warmup plan beyond the budget), else None."""
        self.calls += 1
        key = abstract_signature(args)
        if key in self._seen:
            self._last = key
            self._last_args_paths = []
            return None
        first = not self._seen
        prev, prev_paths = self._last, self._last_args_paths
        self._seen[key] = self.calls
        self._last = key
        self._last_args_paths = _signature_paths(args)
        if first:
            self.compiles_in_warmup += 1
            return None
        in_warmup = self.calls <= self.warmup_steps
        if in_warmup and len(self._seen) <= max(1, self.budget):
            self.compiles_in_warmup += 1
            return None
        paths = prev_paths or self._last_args_paths
        diff = signature_diff(prev, key, paths) if prev is not None else [
            "first signature unavailable"]
        self.last_diff = diff
        self.retraces += 1
        return diff

    def register_warmup(self, args: Tuple) -> None:
        """Record a signature as a warmup plan without counting a call: a
        planned shape (a serving bucket, a prefill bucket, the decode
        graph's one shape) is known work however late it first appears,
        never a post-warmup retrace.  Idempotent per signature."""
        key = abstract_signature(args)
        if key not in self._seen:
            self._seen[key] = 0     # registered ahead of any call
            self.compiles_in_warmup += 1

    def check(self, args: Tuple) -> None:
        """Observe one call and answer a retrace by the mode: strict
        raises :class:`RetraceError`, warn logs the diff."""
        diff = self.observe(args)
        if diff is None:
            return
        msg = (
            f"{self.name}: step called with a new signature at call "
            f"{self.calls} (signature #{len(self._seen)}, warmup="
            f"{self.warmup_steps}, budget={self.budget}) - signature "
            "delta:\n" + "\n".join(diff) +
            "\nA post-warmup signature change makes the card plan the step "
            "again (cuDNN autotune, cuBLAS plans, a CUDA graph recapture) at "
            "every occurrence; stabilize the argument signature (pad uneven "
            "batches, pin dtypes).  Silence with bigdl.analysis.retrace=off.")
        if self.mode == "strict":
            raise RetraceError(msg)
        logger.warning("%s", msg)

    # -- wrapping ---------------------------------------------------------

    def wrap(self, fn):
        def wrapped(*args):
            self.check(args)
            return fn(*args)

        wrapped.sentinel = self
        wrapped.__wrapped__ = fn
        return wrapped


class Spec:
    """Shape and dtype of an argument not made yet (JAX's
    ``ShapeDtypeStruct``), for :meth:`RetraceSentinel.register_warmup`;
    ``dtype`` is a torch dtype, a numpy dtype or a numpy scalar type."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype) if isinstance(dtype, type) else dtype
