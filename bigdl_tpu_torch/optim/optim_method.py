"""OptimMethod: gradient-descent rules (``bigdl_tpu/optim/optim_method.py``:
``OptimMethod`` :39, ``LearningRateSchedule``/``Default`` :125-141, ``SGD``
:325-376, ``Adam`` :435-472; reference ``optim/SGD.scala:38``,
``optim/Adam.scala``).

As in the JAX package every method is split into

- ``init_slots(params)``: per-parameter slot lists (momentum, moments), one
  tensor for each parameter, in a dict keyed by the reference's names;
- ``hyper()``: the step's dynamic scalars (decayed rate, step count),
  computed on the host from ``state``;
- ``pure_update(grads, params, slots, hyper) -> (new_params, new_slots)``:
  the update as a function.  It reads ``grads``, ``params`` and ``slots``
  (lists of tensors in the model's parameter order) and returns new lists;
  it writes none of its inputs, so the trainer's divergence guard can still
  keep the pre-step values.  The arithmetic runs through ``torch._foreach_*``
  (one launch per operation over all tensors on the card) and allocates
  its results; the trainer then writes them into the parameters and slots in
  place (:func:`bigdl_tpu_torch.optim.optimizer.select_tree`);
- a stateful shell with the reference's state keys (``evalCounter``,
  ``epoch``, the negated ``clr``).

Hyper-parameters follow the reference's names and defaults.  Only ``SGD``
(with the ``Default`` schedule) and ``Adam`` are ported so far.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

Tensors = List[torch.Tensor]


class OptimMethod:
    """Base class.  ``state`` is a plain dict (the reference's state Table)."""

    def __init__(self):
        self.state: Dict[str, Any] = {"evalCounter": 0, "epoch": 1}
        self._slots: Optional[Dict[str, Tensors]] = None

    # ---- the update ------------------------------------------------------

    def init_slots(self, params: Tensors) -> Dict[str, Tensors]:
        return {}

    def hyper(self) -> Dict[str, float]:
        """Dynamic scalars for this step, computed on the host."""
        return {"t": float(self.state.get("evalCounter", 0))}

    def pure_update(self, grads: Tensors, params: Tensors,
                    slots: Dict[str, Tensors], hyper: Dict[str, float]
                    ) -> Tuple[Tensors, Dict[str, Tensors]]:
        raise NotImplementedError(type(self).__name__)

    # ---- stateful shell --------------------------------------------------

    def slots(self, params: Tensors) -> Dict[str, Tensors]:
        if self._slots is None:
            self._slots = self.init_slots(params)
        return self._slots

    def set_slots(self, slots: Dict[str, Tensors]) -> None:
        """Adopt per-parameter slots (a data-parallel run publishes its
        gathered shards here)."""
        self._slots = slots

    def step_done(self) -> None:
        """Advance the host counters after a step."""
        self.state["evalCounter"] = self.state.get("evalCounter", 0) + 1


# ---------------------------------------------------------------------------
# learning-rate schedules (reference optim/SGD.scala:198-560)
# ---------------------------------------------------------------------------

class LearningRateSchedule:
    """Computes the current rate from the optimizer's host state and stores
    the negated value in ``state["clr"]`` (the reference's convention)."""

    def update_hyper_parameter(self, optim: "SGD") -> None:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + nevals * lrd) (reference ``SGD.Default``)."""

    def update_hyper_parameter(self, optim: "SGD") -> None:
        n = optim.state["evalCounter"]
        optim.state["clr"] = -optim.learning_rate / (
            1 + n * optim.learning_rate_decay)


# ---------------------------------------------------------------------------
# methods
# ---------------------------------------------------------------------------

def _zeros_like(params: Tensors) -> Tensors:
    return [torch.zeros_like(p) for p in params]


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov and weight decay (reference
    ``optim/SGD.scala:38``).  The first step sets the momentum buffer to the
    gradient (torch's convention, as the JAX package)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__()
        if dampening is None:
            dampening = momentum if not nesterov else 0.0
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0 "
                "(reference SGD.scala requirement)")
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default()

    def init_slots(self, params):
        if self.momentum > 0:
            return {"dfdx": _zeros_like(params)}
        return {}

    def hyper(self):
        self.schedule.update_hyper_parameter(self)
        return {"lr": -self.state["clr"],
                "t": float(self.state.get("evalCounter", 0))}

    def pure_update(self, grads, params, slots, hyper):
        lr, t = hyper["lr"], hyper["t"]
        wd, mom, damp = self.weight_decay, self.momentum, self.dampening
        if wd != 0:
            grads = torch._foreach_add(grads, params, alpha=wd)
        if mom > 0:
            if t == 0:   # first step: v = g
                dfdx = [g.clone() for g in grads]
            else:
                dfdx = torch._foreach_mul(slots["dfdx"], mom)
                torch._foreach_add_(dfdx, grads, alpha=1 - damp)
            slots = {"dfdx": dfdx}
            if self.nesterov:
                grads = torch._foreach_add(grads, dfdx, alpha=mom)
            else:
                grads = dfdx
        return torch._foreach_add(params, grads, alpha=-lr), slots


class Adam(OptimMethod):
    """(reference ``optim/Adam.scala``; lr=1e-3, beta1=0.9, beta2=0.999,
    eps=1e-8, bias-corrected with t = evalCounter + 1)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"s": _zeros_like(params), "r": _zeros_like(params)}

    def hyper(self):
        n = self.state.get("evalCounter", 0)
        clr = self.learning_rate / (1 + n * self.learning_rate_decay)
        self.state["clr"] = -clr
        return {"lr": clr, "t": float(n + 1)}

    def pure_update(self, grads, params, slots, hyper):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        lr, t = hyper["lr"], hyper["t"]
        s = torch._foreach_mul(slots["s"], b1)
        torch._foreach_add_(s, grads, alpha=1 - b1)
        r = torch._foreach_mul(slots["r"], b2)
        torch._foreach_addcmul_(r, grads, grads, value=1 - b2)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        # p - lr * (s / bc1) / (sqrt(r / bc2) + eps)
        denom = torch._foreach_div(r, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(s, bc1)
        torch._foreach_div_(step, denom)
        return torch._foreach_add(params, step, alpha=-lr), {"s": s, "r": r}
