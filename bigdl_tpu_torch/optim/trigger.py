"""Trigger: composable predicates over the training loop's state
(``bigdl_tpu/optim/trigger.py``; reference ``optim/Trigger.scala``:
everyEpoch:37, severalIteration:63, maxEpoch:79, maxIteration:95,
maxScore:107, minLoss:119, plus and/or combinators).

The loop state is a plain dict with the reference's keys: ``epoch``,
``neval`` (1-based iteration counter), ``score``, ``Loss``.
"""

from __future__ import annotations

from typing import Callable, Dict


class Trigger:
    def __init__(self, fn: Callable[[Dict], bool], reads_loss: bool = False):
        self._fn = fn
        # a loop that reads losses late must catch up before evaluating a
        # loss-reading trigger; the flag propagates through and_/or_
        self.reads_loss = reads_loss

    def __call__(self, state: Dict) -> bool:
        return self._fn(state)

    def and_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) and other(s),
                       reads_loss=self.reads_loss or other.reads_loss)

    def or_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) or other(s),
                       reads_loss=self.reads_loss or other.reads_loss)

    def __and__(self, other):
        return self.and_(other)

    def __or__(self, other):
        return self.or_(other)


def every_epoch() -> Trigger:
    """Fires when the epoch counter advances (reference ``everyEpoch:37``)."""
    last = {"epoch": None}

    def fn(state):
        e = state.get("epoch")
        if last["epoch"] is None:
            last["epoch"] = e
            return False
        if e != last["epoch"]:
            last["epoch"] = e
            return True
        return False

    return Trigger(fn)


def several_iteration(interval: int) -> Trigger:
    """Every N iterations (reference ``severalIteration:63``)."""
    return Trigger(lambda s: s.get("neval", 0) % interval == 0
                   and s.get("neval", 0) > 0)


def max_epoch(n: int) -> Trigger:
    """End-condition: epoch > n (reference ``maxEpoch:79``)."""
    return Trigger(lambda s: s.get("epoch", 1) > n)


def max_iteration(n: int) -> Trigger:
    """End-condition: neval > n (reference ``maxIteration:95``)."""
    return Trigger(lambda s: s.get("neval", 1) > n)


def max_score(score: float) -> Trigger:
    """(reference ``maxScore:107``).  Inert until a validation has set
    ``score`` (the loop state initialises it to None)."""
    def fn(s):
        v = s.get("score")
        return v is not None and v > score
    return Trigger(fn)


def min_loss(loss: float) -> Trigger:
    """(reference ``minLoss:119``).  Inert until the first iteration has
    set ``Loss``; ``reads_loss=True``."""
    def fn(s):
        v = s.get("Loss")
        return v is not None and v < loss
    return Trigger(fn, reads_loss=True)
