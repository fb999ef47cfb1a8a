"""Module contract checker (``bigdl_tpu/analysis/contracts.py``): shape,
dtype and layout analysis at zero FLOPs.

Every :class:`~bigdl_tpu_torch.nn.module.Module` may declare a
:class:`ModuleContract` (the class attribute ``contract``, or per instance
through ``set_contract``): the input ranks it accepts, its dtype policy, and
whether its float output should follow its float input's dtype.
:func:`check_model` walks a model ONCE and reports:

- **contract violations**: an input rank or dtype a module said it cannot
  take;
- **promotion drift**: a float output wider than the module's float input
  (bf16 in, fp32 out runs the rest of the network at twice the cost) and
  any float64/complex128 leaf (x64 drift);
- **layout violations**: a spatial module configured ``NCHW`` running
  inside an NHWC region (or the other way round), closing the loop on the
  channels-last conversion of ``nn/layout.py``.

The walk is the JAX package's ``jax.eval_shape`` in PyTorch: the model runs
under :func:`torch.func.functional_call` over ``meta``-device copies of its
parameters and buffers, with a ``meta`` input, so every operation computes
shapes and dtypes only -- no FLOP, no kernel on the card, no write to the
model's tensors.  A forward pre-hook and a forward hook on each module
record its input and output leaves' ranks and dtypes; the hooks are removed
and every module's train/eval mode put back when the walk ends.
``bigdl.analysis.contracts`` picks strict (:class:`ContractError`) / warn /
off for :meth:`ContractReport.raise_if_strict`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

logger = logging.getLogger("bigdl_tpu_torch")


class ContractError(ValueError):
    """A model violated a declared module contract (strict mode)."""


def _dtype_name(dtype) -> str:
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


@dataclass(frozen=True)
class ModuleContract:
    """Declarative IO contract of one module class or instance.

    ``input_ndim``: the allowed rank(s) of tensor inputs (None = any).
    ``dtypes``: "float", "int", "any", or a tuple of dtype names
    (numpy's: ``"float32"``, ``"bfloat16"``, ``"int64"``).
    ``follows_input_dtype``: when True (the default for float-to-float
    modules), a float output wider than the widest float input is
    reported as promotion drift."""

    input_ndim: Optional[Tuple[int, ...]] = None
    dtypes: Any = "any"
    follows_input_dtype: bool = True

    def __post_init__(self):
        nd = self.input_ndim
        if isinstance(nd, int):
            object.__setattr__(self, "input_ndim", (nd,))
        elif nd is not None:
            object.__setattr__(self, "input_ndim", tuple(nd))

    def allows_dtype(self, dtype) -> bool:
        """Whether a tensor of torch ``dtype`` may come in."""
        if self.dtypes == "any":
            return True
        if self.dtypes == "float":
            return dtype.is_floating_point
        if self.dtypes == "int":
            return not (dtype.is_floating_point or dtype.is_complex or
                        str(dtype) == "torch.bool")
        return _dtype_name(dtype) in tuple(self.dtypes)


@dataclass
class Violation:
    module: str            # container path, e.g. Sequential[3].SpatialConvolution
    kind: str              # "ndim" | "dtype" | "promotion" | "x64" | "layout"
    detail: str

    def __str__(self):
        return f"[{self.kind}] {self.module}: {self.detail}"


def _module_paths(model) -> dict:
    """id(module) -> container path (``Sequential[3].SpatialConvolution``;
    nested containers chain: ``Sequential[0].Sequential[2].Linear``) for
    every module reached through container children; a module inside a
    non-container layer gets its torch path under the nearest one."""
    from bigdl_tpu_torch.nn.module import Container
    paths: dict = {}

    def walk(m, prefix: str) -> None:
        if isinstance(m, Container):
            for i, child in enumerate(m.layers):
                cp = f"{prefix}[{i}].{type(child).__name__}"
                paths[id(child)] = cp
                walk(child, cp)
        else:
            for name, child in m.named_children():
                cp = f"{prefix}.{name}"
                paths.setdefault(id(child), cp)
                walk(child, cp)

    walk(model, type(model).__name__)
    return paths


@dataclass
class ContractReport:
    violations: List[Violation] = field(default_factory=list)
    modules_checked: int = 0
    trace_error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return not self.violations and self.trace_error is None

    def by_kind(self, kind: str) -> List[Violation]:
        return [v for v in self.violations if v.kind == kind]

    def __str__(self):
        if self.ok:
            return (f"contract check: {self.modules_checked} modules, "
                    "no violations")
        lines = [f"contract check: {self.modules_checked} modules, "
                 f"{len(self.violations)} violation(s)"]
        lines += [f"  {v}" for v in self.violations]
        if self.trace_error:
            lines.append(f"  trace aborted: {self.trace_error}")
        return "\n".join(lines)

    def raise_if_strict(self, mode: Optional[str] = None) -> "ContractReport":
        from bigdl_tpu_torch.analysis import pass_mode
        mode = mode or pass_mode("contracts")
        if self.ok or mode == "off":
            return self
        if mode == "strict":
            raise ContractError(str(self))
        logger.warning("%s", self)
        return self


def _tensor_leaves(x) -> List:
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in _tensor_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _tensor_leaves(v)]
    return []


def _widest_float(leaves):
    widths = [l.element_size() for l in leaves if l.is_floating_point()]
    return max(widths) if widths else None


def _torch_dtype(dtype):
    import numpy as np
    import torch
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _to_meta(x):
    """The sample input on the ``meta`` device: tensors, numpy arrays and
    (shape, dtype) stand-ins (``analysis.retrace.Spec``) alike."""
    import numpy as np
    import torch
    if isinstance(x, dict):
        return {k: _to_meta(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, np.ndarray) or (hasattr(x, "shape") and
                                     hasattr(x, "dtype")):
        return torch.empty(tuple(x.shape), dtype=_torch_dtype(x.dtype),
                           device="meta")
    return x


def check_model(model, sample_input, *, training: bool = False,
                mode: Optional[str] = None) -> ContractReport:
    """Walk ``model`` over ``sample_input`` on the ``meta`` device and check
    every module's declared contract and the global dtype and layout
    invariants.  ``sample_input`` may be tensors (any device), numpy arrays
    or (shape, dtype) stand-ins -- either way no FLOP runs.

    Violations are kept even when the walk itself dies (a rank mismatch
    usually fails an op a layer later; the report then carries both the
    contract finding and the error)."""
    import torch
    from torch.func import functional_call
    from bigdl_tpu_torch.nn.module import Container
    from bigdl_tpu_torch.nn.layout import NCHWToNHWC, NHWCToNCHW

    paths = _module_paths(model)
    report = ContractReport()
    region = {"layout": "NCHW"}    # the facade's layout at the boundary
    handles = []

    def where(m) -> str:
        return paths.get(id(m), type(m).__name__)

    def check_inputs(m, args) -> None:
        """Input-side checks run BEFORE the module's forward, so a
        violation is on record even when the mismatch kills the walk a
        moment later."""
        report.modules_checked += 1
        in_leaves = _tensor_leaves(args)
        contract: Optional[ModuleContract] = getattr(m, "contract", None)
        if contract is not None:
            for l in in_leaves:
                if (contract.input_ndim is not None and
                        l.dim() not in contract.input_ndim):
                    report.violations.append(Violation(
                        where(m), "ndim",
                        f"input rank {l.dim()} (shape {tuple(l.shape)}) "
                        f"not in declared {contract.input_ndim}"))
                if not contract.allows_dtype(l.dtype):
                    report.violations.append(Violation(
                        where(m), "dtype",
                        f"input dtype {_dtype_name(l.dtype)} violates "
                        f"declared policy {contract.dtypes!r}"))
        # layout: a spatial op must match the region the boundary
        # transposes established
        if getattr(m, "layout_role", "opaque") == "spatial":
            fmt = getattr(m, "format", "NCHW")
            if any(l.dim() in (3, 4) for l in in_leaves) and \
                    fmt != region["layout"]:
                report.violations.append(Violation(
                    where(m), "layout",
                    f"{fmt}-configured spatial op inside an "
                    f"{region['layout']} region - the boundary transposes "
                    "and the op's data format disagree"))

    def check_outputs(m, args, out) -> None:
        in_leaves = _tensor_leaves(args)
        out_leaves = _tensor_leaves(out)
        contract: Optional[ModuleContract] = getattr(m, "contract", None)
        for l in out_leaves:
            if l.dtype in (torch.float64, torch.complex128):
                report.violations.append(Violation(
                    where(m), "x64",
                    f"output leaf is {_dtype_name(l.dtype)} - x64 "
                    "promotion drift"))
        if contract is None or contract.follows_input_dtype:
            win, wout = _widest_float(in_leaves), _widest_float(out_leaves)
            if win is not None and wout is not None and wout > win:
                report.violations.append(Violation(
                    where(m), "promotion",
                    f"float output widens {win * 8}-bit input to "
                    f"{wout * 8}-bit - promotion drift (a constant or "
                    "state leaf is pinning a wider dtype)"))

    def set_region(layout):
        def hook(m, args, out):
            region["layout"] = layout
        return hook

    for m in model.modules():
        if isinstance(m, NCHWToNHWC):
            handles.append(m.register_forward_hook(set_region("NHWC")))
        elif isinstance(m, NHWCToNCHW):
            handles.append(m.register_forward_hook(set_region("NCHW")))
        elif not isinstance(m, Container):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args: check_inputs(mod, args)))
            handles.append(m.register_forward_hook(
                lambda mod, args, out: check_outputs(mod, args, out)))
    modes = [(m, m.training) for m in model.modules()]
    tensors = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
               for k, v in list(model.named_parameters()) +
               list(model.named_buffers())}
    try:
        model.train(training)
        try:
            with torch.no_grad():
                functional_call(model, tensors, (_to_meta(sample_input),))
        except ContractError:
            raise
        except Exception as e:  # the walk died: report what was seen
            report.trace_error = f"{type(e).__name__}: {e}"
    finally:
        for h in handles:
            h.remove()
        for m, was in modes:
            m.training = was
    return report.raise_if_strict(mode)
