"""Mixed-precision forward (``bigdl_tpu/optim/optimizer.py``
``mixed_precision_forward`` :102).  The optimizers and their fused step come
with the training slice."""

from __future__ import annotations

import torch
from torch.func import functional_call


def cast_floats(tree, dtype: torch.dtype):
    """Cast every floating tensor of a nested list/tuple/dict to ``dtype``;
    other leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def mixed_precision_forward(model: torch.nn.Module, inputs,
                            precision: str = "bf16"):
    """Forward in the compute precision, outputs back in fp32.

    ``"bf16"``: the parameters and the floating inputs are cast down for
    the forward (the model's own fp32 parameters stay as they are) and the
    outputs come back as fp32; buffers keep their dtype, as the JAX package
    keeps module state in fp32.  As there, float token ids are cast too, so
    ids above 256 round to bf16's grid.  Any other precision is a plain
    forward."""
    if precision != "bf16":
        return model(inputs)
    params = cast_floats(dict(model.named_parameters()), torch.bfloat16)
    out = functional_call(model, params,
                          (cast_floats(inputs, torch.bfloat16),))
    return cast_floats(out, torch.float32)
