"""OptimMethod: gradient-descent rules (``bigdl_tpu/optim/optim_method.py``:
``OptimMethod`` :39, ``save``/``load`` :97-105, the learning-rate schedules
:125-322, ``SGD`` :325, ``Adagrad`` :378, ``Adadelta`` :410, ``Adam`` :435,
``Adamax`` :473, ``RMSprop`` :503; reference ``optim/SGD.scala:38``,
``optim/Adagrad.scala``, ``optim/Adadelta.scala``, ``optim/Adam.scala``,
``optim/Adamax.scala``, ``optim/RMSprop.scala``).

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

Hyper-parameters follow the reference's names and defaults.  ``LBFGS``
(:535, with ``_lswolfe`` :654) is the exception to the split: its line
search re-evaluates the loss inside a step, so it has no ``pure_update``
and runs host-driven through ``optimize(feval, x)``, which
``LocalOptimizer``'s feval step calls.

Persistence.  The JAX package pickles the whole object.  Here an
``OptimMethod`` is saved as plain data (:func:`optim_payload`: the class
name, its scalar hyper-parameters, its schedule's class and scalar
fields, the ``state`` dict and the slots as CPU tensors), written with
``torch.save`` and read back with ``torch.load(weights_only=True)``, so
nothing arbitrary is unpickled and a snapshot does not depend on a
class's pickled layout.  :func:`load_payload` puts such a payload into a
live method; :meth:`OptimMethod.load` rebuilds one from its class name.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

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

    def get_learning_rate(self) -> float:
        """The current learning rate (``state["clr"]`` negated, the
        reference's convention); 0.0 before the first step."""
        return -float(self.state.get("clr", 0.0))

    def save(self, path: str, overwrite: bool = True) -> "OptimMethod":
        """Write :func:`optim_payload` to ``path`` atomically."""
        from bigdl_tpu_torch.utils import file_io
        file_io.save(optim_payload(self), path, overwrite)
        return self

    @staticmethod
    def load(path: str) -> "OptimMethod":
        """Rebuild a method saved by :meth:`save` from its class name."""
        from bigdl_tpu_torch.utils import file_io
        return from_payload(file_io.load(path))


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


class Step(LearningRateSchedule):
    """lr * gamma^(floor(nevals / step_size)) (reference ``SGD.Step:316``)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def update_hyper_parameter(self, optim: "SGD") -> None:
        n = optim.state["evalCounter"]
        optim.state["clr"] = -optim.learning_rate * (
            self.gamma ** (n // self.step_size))


class MultiStep(LearningRateSchedule):
    """lr * gamma^(steps passed) (reference ``SGD.MultiStep:349``)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def update_hyper_parameter(self, optim: "SGD") -> None:
        n = optim.state["evalCounter"]
        k = sum(1 for s in self.step_sizes if n >= s)
        optim.state["clr"] = -optim.learning_rate * (self.gamma ** k)


class EpochStep(LearningRateSchedule):
    """lr * gamma^(floor((epoch-1)/step)) (reference ``SGD.EpochStep:412``)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def update_hyper_parameter(self, optim: "SGD") -> None:
        epoch = optim.state.get("epoch", 1)
        optim.state["clr"] = -optim.learning_rate * (
            self.gamma ** ((epoch - 1) // self.step_size))


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decayFn(epoch) (reference ``SGD.EpochDecay:385``).
    ``decay_fn`` is code, not data: a saved method does not carry it."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def update_hyper_parameter(self, optim: "SGD") -> None:
        epoch = optim.state.get("epoch", 1)
        optim.state["clr"] = -optim.learning_rate * (
            0.1 ** self.decay_fn(epoch))


class Poly(LearningRateSchedule):
    """lr * (1 - iter/max)^power, 0 past max (reference ``SGD.Poly:281``)."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def update_hyper_parameter(self, optim: "SGD") -> None:
        n = optim.state["evalCounter"]
        if n > self.max_iteration:
            optim.state["clr"] = 0.0
        else:
            optim.state["clr"] = -optim.learning_rate * (
                (1.0 - n / self.max_iteration) ** self.power)


class Exponential(LearningRateSchedule):
    """lr * gamma^(iter/decayStep), optionally staircased
    (reference ``SGD.Exponential:467``)."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def update_hyper_parameter(self, optim: "SGD") -> None:
        n = optim.state["evalCounter"]
        p = n / self.decay_step
        if self.stair_case:
            p = float(int(p))
        optim.state["clr"] = -optim.learning_rate * (self.decay_rate ** p)


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(iter/decayStep))
    (reference ``SGD.NaturalExp:446``)."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def update_hyper_parameter(self, optim: "SGD") -> None:
        n = optim.state["evalCounter"]
        optim.state["clr"] = -optim.learning_rate * math.exp(
            -self.gamma * (n // self.decay_step))


class Regime:
    """(startEpoch, endEpoch, config) (reference ``SGD.Regime``)."""

    def __init__(self, start_epoch: int, end_epoch: int,
                 config: Dict[str, Any]):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """Per-epoch-range hyper-parameter regimes: the regime whose range
    holds the epoch sets the method's attributes (reference
    ``SGD.EpochSchedule:224``)."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def update_hyper_parameter(self, optim: "SGD") -> None:
        epoch = optim.state.get("epoch", 1)
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                for k, v in r.config.items():
                    setattr(optim, k, v)
        optim.state["clr"] = -optim.learning_rate


class Plateau(LearningRateSchedule):
    """Reduce the rate by ``factor`` when ``monitor`` (``"score"``, which
    validation sets, or ``"Loss"``) has not improved for ``patience``
    epochs (reference ``SGD.Plateau:534``).  Its counters advance once per
    epoch and live on the schedule."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._wait = 0
        self._cooldown_counter = 0
        self._best: Optional[float] = None
        self._current_lr: Optional[float] = None
        self._cur_epoch = -1

    def _is_better(self, cur: float, best: float) -> bool:
        if self.mode == "min":
            return cur < best - self.epsilon
        return cur > best + self.epsilon

    def update_hyper_parameter(self, optim: "SGD") -> None:
        if self._current_lr is None:
            self._current_lr = optim.learning_rate
        optim.state["clr"] = -self._current_lr
        # once per epoch (reference SGD.Plateau:558)
        epoch = optim.state.get("epoch", 1)
        if epoch == self._cur_epoch:
            return
        self._cur_epoch = epoch
        metric = optim.state.get(self.monitor)
        if metric is None:
            return
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        if self._best is None or self._is_better(metric, self._best):
            self._best = metric
            self._wait = 0
        elif self._cooldown_counter <= 0:
            self._wait += 1
            if self._wait >= self.patience:
                self._current_lr = max(self._current_lr * self.factor,
                                       self.min_lr)
                self._cooldown_counter = self.cooldown
                self._wait = 0
        optim.state["clr"] = -self._current_lr


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


class Adagrad(OptimMethod):
    """(reference ``optim/Adagrad.scala``): the squared gradients summed in
    ``var``; p - lr * g / (sqrt(var) + 1e-10)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_slots(self, params):
        return {"var": _zeros_like(params)}

    def hyper(self):
        n = self.state.get("evalCounter", 0)
        clr = self.learning_rate / (1 + n * self.learning_rate_decay)
        self.state["clr"] = -clr
        return {"lr": clr, "t": float(n)}

    def pure_update(self, grads, params, slots, hyper):
        lr = hyper["lr"]
        if self.weight_decay != 0:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        var = torch._foreach_addcmul(slots["var"], grads, grads)
        denom = torch._foreach_sqrt(var)
        torch._foreach_add_(denom, 1e-10)
        step = torch._foreach_div(grads, denom)
        return torch._foreach_add(params, step, alpha=-lr), {"var": var}


class Adadelta(OptimMethod):
    """(reference ``optim/Adadelta.scala``; decayRate 0.9, epsilon 1e-10):
    the step sqrt(delta + eps) / sqrt(var + eps) * g, no learning rate."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__()
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"paramVariance": _zeros_like(params),
                "delta": _zeros_like(params)}

    def pure_update(self, grads, params, slots, hyper):
        rho, eps = self.decay_rate, self.epsilon
        var = torch._foreach_mul(slots["paramVariance"], rho)
        torch._foreach_addcmul_(var, grads, grads, value=1 - rho)
        num = torch._foreach_add(slots["delta"], eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(var, eps)
        torch._foreach_sqrt_(den)
        upd = torch._foreach_div(num, den)
        torch._foreach_mul_(upd, grads)
        delta = torch._foreach_mul(slots["delta"], rho)
        torch._foreach_addcmul_(delta, upd, upd, value=1 - rho)
        return (torch._foreach_sub(params, upd),
                {"paramVariance": var, "delta": delta})


class Adamax(OptimMethod):
    """(reference ``optim/Adamax.scala``; lr 2e-3): the first moment ``m``
    and the infinity norm ``u``; p - lr / (1 - beta1^t) * m / u."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__()
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    def hyper(self):
        n = self.state.get("evalCounter", 0)
        return {"lr": self.learning_rate, "t": float(n + 1)}

    def pure_update(self, grads, params, slots, hyper):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        lr, t = hyper["lr"], hyper["t"]
        m = torch._foreach_mul(slots["m"], b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        absg = torch._foreach_abs(grads)
        torch._foreach_add_(absg, eps)
        u = torch._foreach_mul(slots["u"], b2)
        torch._foreach_maximum_(u, absg)
        clr = lr / (1 - b1 ** t)
        step = torch._foreach_div(m, u)
        return torch._foreach_add(params, step, alpha=-clr), {"m": m, "u": u}


class RMSprop(OptimMethod):
    """(reference ``optim/RMSprop.scala``; lr 1e-2, decayRate 0.99):
    p - lr * g / (sqrt(sumSquare) + eps)."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 decay_rate: float = 0.99, epsilon: float = 1e-8):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    def init_slots(self, params):
        return {"sumSquare": _zeros_like(params)}

    def hyper(self):
        n = self.state.get("evalCounter", 0)
        clr = self.learning_rate / (1 + n * self.learning_rate_decay)
        self.state["clr"] = -clr
        return {"lr": clr, "t": float(n)}

    def pure_update(self, grads, params, slots, hyper):
        rho, eps = self.decay_rate, self.epsilon
        r = torch._foreach_mul(slots["sumSquare"], rho)
        torch._foreach_addcmul_(r, grads, grads, value=1 - rho)
        denom = torch._foreach_sqrt(r)
        torch._foreach_add_(denom, eps)
        step = torch._foreach_div(grads, denom)
        return (torch._foreach_add(params, step, alpha=-hyper["lr"]),
                {"sumSquare": r})


class LBFGS(OptimMethod):
    """Limited-memory BFGS with an optional strong-Wolfe line search
    (``bigdl_tpu/optim/optim_method.py`` :535; reference
    ``optim/LBFGS.scala``).

    Host-driven by design, as in the JAX package and the reference: one
    flat fp32 vector on the parameters' device, the two-loop recursion
    over the curvature history, and a ``float()`` of every reduction (the
    gradient's max and L1 norm, each dot product, the loss), each an
    intended pull that steers the next step.  ``state`` keeps
    ``old_dirs``/``old_stps`` (the history, ``2 * n_correction`` vectors of
    the parameters' size), ``Hdiag``, ``prev_g``, ``prev_step`` and
    ``prev_loss`` between calls.  The trainers run it through
    ``LocalOptimizer``'s feval step, which calls :meth:`optimize`."""

    #: the trainer uses the host-driven ``optimize(feval, x)`` path instead
    #: of the step's ``pure_update`` (the line search re-evaluates the loss)
    requires_feval = True

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tolerance_fun: float = 1e-5, tolerance_x: float = 1e-9,
                 n_correction: int = 100, learning_rate: float = 1.0,
                 line_search: bool = False):
        super().__init__()
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 1.25
        self.tolerance_fun = tolerance_fun
        self.tolerance_x = tolerance_x
        self.n_correction = n_correction
        self.learning_rate = learning_rate
        self.line_search = line_search

    def pure_update(self, grads, params, slots, hyper):
        raise NotImplementedError(
            "LBFGS needs re-evaluation inside the step; use optimize(feval, x)")

    def optimize(self, feval: Callable, x):
        """One call of the inner loop (torch ``lbfgs`` semantics).  ``x``
        is a tensor or a list/tuple of tensors, flattened internally;
        ``feval(x) -> (loss, grad)`` in ``x``'s structure.  Returns the new
        ``x`` and the tuple of losses (Python floats), one per iteration
        plus the starting one."""
        leaves = [x] if isinstance(x, torch.Tensor) else list(x)
        shapes = [l.shape for l in leaves]

        def to_flat(t):
            ls = [t] if isinstance(t, torch.Tensor) else list(t)
            return torch.cat([l.reshape(-1) for l in ls])

        def from_flat(vec):
            out, off = [], 0
            for shp in shapes:
                n = math.prod(shp)
                out.append(vec[off:off + n].reshape(shp))
                off += n
            if isinstance(x, torch.Tensor):
                return out[0]
            return type(x)(out)

        def feval_flat(vec):
            loss, g = feval(from_flat(vec))
            return float(loss), to_flat(g)

        f, g = feval_flat(to_flat(x))
        xv = to_flat(x)
        losses = [f]
        n_eval = 1

        old_dirs = self.state.setdefault("old_dirs", [])
        old_stps = self.state.setdefault("old_stps", [])
        hdiag = self.state.get("Hdiag", 1.0)
        prev_g = self.state.get("prev_g")
        prev_loss = self.state.get("prev_loss", f)

        for _ in range(self.max_iter):
            if float(g.abs().max()) <= 1e-10:
                break
            if prev_g is not None and "prev_step" in self.state:
                y = g - prev_g
                s = self.state["prev_step"]
                ys = float(y @ s)
                if ys > 1e-10:
                    if len(old_dirs) == self.n_correction:
                        old_dirs.pop(0)
                        old_stps.pop(0)
                    old_dirs.append(s)
                    old_stps.append(y)
                    hdiag = ys / float(y @ y)
            # the L-BFGS two-loop recursion
            k = len(old_dirs)
            ro = [1.0 / float(old_stps[i] @ old_dirs[i]) for i in range(k)]
            al = [0.0] * k
            q = -g
            for i in range(k - 1, -1, -1):
                al[i] = float(old_dirs[i] @ q) * ro[i]
                q = q - al[i] * old_stps[i]
            d = q * hdiag
            for i in range(k):
                be = float(old_stps[i] @ d) * ro[i]
                d = d + old_dirs[i] * (al[i] - be)

            gtd = float(g @ d)
            if gtd > -self.tolerance_x:
                break
            if prev_g is None:
                t = min(1.0, 1.0 / float(g.abs().sum())) * self.learning_rate
            else:
                t = self.learning_rate

            prev_g = g
            self.state["prev_g"] = g
            if self.line_search:
                t, f, g, xv, ls_evals = _lswolfe(feval_flat, xv, t, d, f, g,
                                                 gtd)
                n_eval += ls_evals
            else:
                xv = xv + t * d
                f, g = feval_flat(xv)
                n_eval += 1
            losses.append(f)
            self.state["prev_step"] = t * d

            if n_eval >= self.max_eval:
                break
            if abs(losses[-1] - prev_loss) < self.tolerance_fun:
                break
            prev_loss = losses[-1]
            self.state["prev_loss"] = prev_loss

        self.state["Hdiag"] = hdiag
        self.state["evalCounter"] = self.state.get("evalCounter", 0) + 1
        return from_flat(xv), tuple(losses)


def _lswolfe(feval_flat, xv, t, d, f, g, gtd,
             c1: float = 1e-4, c2: float = 0.9, max_ls: int = 25):
    """The strong-Wolfe line search (JAX :654, a backtracking/extending
    search with simplified bracketing).  Returns ``(t, f, g, x, evals)``,
    all of the SAME evaluated point ``xv + t * d``, so the caller's
    curvature pair stays consistent."""
    f0, gtd0 = f, gtd
    evals = 0
    f_prev = f
    # the last evaluated point (step, loss, gradient)
    t_eval, f_eval, g_eval = 0.0, f, g
    for _ in range(max_ls):
        f_new, g_new = feval_flat(xv + t * d)
        evals += 1
        t_eval, f_eval, g_eval = t, f_new, g_new
        gtd_new = float(g_new @ d)
        if f_new > f0 + c1 * t * gtd0 or (evals > 1 and f_new >= f_prev):
            t = t * 0.5
            continue
        if abs(gtd_new) <= -c2 * gtd0:
            break
        if gtd_new >= 0:
            t = t * 0.5
            continue
        f_prev = f_new
        t = t * 2.0
    return t_eval, f_eval, g_eval, xv + t_eval * d, evals


# ---------------------------------------------------------------------------
# persistence as plain data
# ---------------------------------------------------------------------------

_PLAIN = (bool, int, float, str, type(None))


def _plain_fields(obj, skip=()) -> Dict[str, Any]:
    """The fields of ``obj`` that are plain scalars (or lists of them); a
    ``Regime`` list becomes a list of ``[start, end, config]``."""
    out = {}
    for k, v in vars(obj).items():
        if k in skip:
            continue
        if isinstance(v, _PLAIN):
            out[k] = v
        elif isinstance(v, (list, tuple)) and all(
                isinstance(x, _PLAIN) for x in v):
            out[k] = list(v)
        elif isinstance(v, list) and all(isinstance(x, Regime) for x in v):
            out[k] = [[r.start_epoch, r.end_epoch, dict(r.config)]
                      for r in v]
    return out


def _set_fields(obj, fields: Dict[str, Any]) -> None:
    for k, v in fields.items():
        if k == "regimes":
            v = [Regime(a, b, dict(c)) for a, b, c in v]
        setattr(obj, k, v)


def optim_payload(method: OptimMethod) -> Dict[str, Any]:
    """``method`` as plain data for ``torch.save``: its class, scalar
    hyper-parameters, schedule (class and scalar fields), ``state`` and
    slots, each slot a full-size CPU tensor.  Read back with
    ``torch.load(weights_only=True)``."""
    slots = None
    if method._slots is not None:
        slots = {k: [t.detach().cpu() for t in v]
                 for k, v in method._slots.items()}
    schedule = getattr(method, "schedule", None)
    return {
        "class": type(method).__name__,
        "hyper": _plain_fields(method, skip=("state", "_slots")),
        "schedule": None if schedule is None else {
            "class": type(schedule).__name__,
            "fields": _plain_fields(schedule)},
        "state": dict(method.state),
        "slots": slots,
    }


def load_payload(method: OptimMethod, payload: Dict[str, Any],
                 device: Optional[torch.device] = None,
                 hyper: bool = True) -> OptimMethod:
    """Put a payload of :func:`optim_payload` into ``method`` in place: its
    ``state`` and slots (moved to ``device``), and with ``hyper`` its
    hyper-parameters and its schedule's fields, as unpickling the JAX
    package's method would give them.  Raises :class:`TypeError` when the
    payload is of another class."""
    if payload["class"] != type(method).__name__:
        raise TypeError(f"snapshot of a {payload['class']} cannot be loaded "
                        f"into a {type(method).__name__}")
    if hyper:
        _set_fields(method, payload["hyper"])
        sched, schedule = payload["schedule"], getattr(method, "schedule",
                                                       None)
        if sched is not None and schedule is not None:
            if sched["class"] != type(schedule).__name__:
                raise TypeError(
                    f"snapshot's schedule is a {sched['class']}, the "
                    f"method's a {type(schedule).__name__}")
            _set_fields(schedule, sched["fields"])
    method.state = dict(payload["state"])
    slots = payload["slots"]
    method.set_slots(None if slots is None else {
        k: [t.to(device) if device is not None else t for t in v]
        for k, v in slots.items()})
    return method


def _subclasses(cls):
    for sub in cls.__subclasses__():
        yield sub
        yield from _subclasses(sub)


def from_payload(payload: Dict[str, Any]) -> OptimMethod:
    """Rebuild a method from :func:`optim_payload` by its class name."""
    classes = {c.__name__: c for c in _subclasses(OptimMethod)}
    cls = classes.get(payload["class"])
    if cls is None:
        raise TypeError(f"unknown OptimMethod class {payload['class']!r}")
    method = cls.__new__(cls)
    OptimMethod.__init__(method)
    sched = payload["schedule"]
    if sched is not None:
        scheds = {c.__name__: c for c in _subclasses(LearningRateSchedule)}
        scls = scheds.get(sched["class"])
        if scls is None or scls is EpochDecay:
            raise NotImplementedError(
                f"schedule {sched['class']!r} holds code, not data: build "
                "the method and load the payload into it (load_payload)")
        method.schedule = scls.__new__(scls)
    return load_payload(method, payload)
