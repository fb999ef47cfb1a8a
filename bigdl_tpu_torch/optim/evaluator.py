"""Eval-mode forward (``bigdl_tpu/optim/evaluator.py`` ``_eval_forward``
:33).  The JAX package memoizes a compiled executable on the model; eager
PyTorch needs none, so this is the forward under ``torch.inference_mode``.
The evaluator and its metrics come with the training slice."""

from __future__ import annotations

from typing import Callable

import torch


def _eval_forward(model: torch.nn.Module) -> Callable:
    """Put ``model`` in eval mode and return its inference forward."""
    model.eval()

    def fwd(inputs):
        with torch.inference_mode():
            return model(inputs)

    return fwd
