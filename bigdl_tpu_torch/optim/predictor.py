"""Predictor: batched inference (``bigdl_tpu/optim/predictor.py``
``Predictor`` :22)."""

from __future__ import annotations

import copy
from typing import List

import numpy as np
import torch

from bigdl_tpu_torch.engine import (DeviceLike, check_on_device,
                                    default_device, to_device)
from bigdl_tpu_torch.nn.fuse import fold_conv_bn
from bigdl_tpu_torch.optim.evaluator import eval_mode
from bigdl_tpu_torch.utils import compile_cache


class Predictor:
    """Inference over an array of rows with the model on ``device``, in eval
    mode (the model's own mode is put back after each ``predict``).

    ``fold_bn=True`` serves a copy of the model in eval mode with every
    conv + BatchNorm pair folded into the convolution
    (:func:`bigdl_tpu_torch.nn.fuse.fold_conv_bn`): one convolution per
    pair, no separate normalisation.  The caller's model is untouched, since
    folding freezes BN at its running statistics."""

    def __init__(self, model: torch.nn.Module, fold_bn: bool = False,
                 device: DeviceLike = "cuda"):
        self.device = default_device(device)
        check_on_device(model, self.device)
        if fold_bn:
            model = fold_conv_bn(copy.deepcopy(model).eval())
        self.model = model

    def predict(self, rows, batch_size: int = 32) -> np.ndarray:
        """Per-row model outputs as one host array.  Batches pad up to the
        ``bigdl.compile.buckets`` plan, as the JAX package's do, and the
        padded rows are sliced off."""
        rows = np.asarray(rows)
        buckets = compile_cache.configured_buckets()
        outs: List[np.ndarray] = []
        with eval_mode(self.model) as fwd:
            for i in range(0, rows.shape[0], batch_size):
                batch = rows[i:i + batch_size]
                n = batch.shape[0]
                eff = compile_cache.bucket_size(n, buckets) if buckets else n
                out = fwd(to_device(compile_cache.pad_batch(batch, n, eff),
                                    self.device))
                outs.append(compile_cache.slice_rows(out.cpu().numpy(), n))
        return np.concatenate(outs, axis=0) if outs else np.empty((0,))
