"""Linear and embedding layers (``bigdl_tpu/nn/linear.py``: ``Linear`` :25,
``Bilinear`` :124, ``LookupTable`` :160, ``Add`` :195, ``Mul`` :213,
``CMul`` :222, ``CAdd`` :242, ``Euclidean`` :262, ``Cosine`` :283).

``Linear`` keeps PyTorch's (out, in) weight; the JAX package stores (in, out),
so :func:`bigdl_tpu_torch.utils.convert.params_from_jax` transposes it.
The other layers keep the JAX package's layouts (``Bilinear``'s (out, in1,
in2), ``Euclidean``'s and ``Cosine``'s (in, out) centres), which carry
over as they are.  Their initial values are drawn U(-stdv, stdv) from the
caller's generator as the JAX package draws them from its key.
``w_regularizer``/``b_regularizer`` (:mod:`bigdl_tpu_torch.optim.regularizer`)
add their penalties to the training loss
(:func:`bigdl_tpu_torch.optim.optimizer.regularization_penalty`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.init import RandomUniform, redraw as _redraw
from bigdl_tpu_torch.nn.module import Module, make_generator
from bigdl_tpu_torch.analysis.contracts import ModuleContract


class Linear(Module):
    """y = x W^T + b (reference ``nn/Linear.scala``), initialised
    U(-1/sqrt(in), 1/sqrt(in)) by
    :class:`~bigdl_tpu_torch.nn.init.RandomUniform`.

    ``_tp`` tags one half of a Megatron pair (``"column"`` or ``"row"``,
    :func:`~bigdl_tpu_torch.parallel.tensor_parallel.column_parallel`);
    while the mesh axis ``model_parallel`` is bound, the layer holds its
    rank's block and runs its half
    (:func:`~bigdl_tpu_torch.parallel.tensor_parallel.linear_forward`,
    which adds a row half's bias after the product, split or not)."""

    #: float matmul input (any rank; the trailing dim contracts with W)
    contract = ModuleContract(dtypes="float")

    _tp: Optional[str] = None
    #: the mesh axis of the Megatron split, set by the trainer
    model_parallel: Optional[str] = None

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        g = make_generator(generator)
        draw = RandomUniform()
        w = draw((output_size, input_size), input_size, generator=g)
        self.weight = nn.Parameter(w.to(device))
        if with_bias:
            b = draw((output_size,), input_size, generator=g)
            self.bias = nn.Parameter(b.to(device))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def set_init_method(self, weight_init=None, bias_init=None,
                        generator: Optional[torch.Generator] = None
                        ) -> "Linear":
        """Redraw the weight and bias as
        :meth:`SpatialConvolution.set_init_method
        <bigdl_tpu_torch.nn.conv.SpatialConvolution.set_init_method>`
        does, with fan_in = ``input_size`` and fan_out = ``output_size``."""
        _redraw(self, weight_init, bias_init, generator,
                (self.input_size, self.output_size))
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self._tp is not None:
            from bigdl_tpu_torch.engine import bound_axis
            from bigdl_tpu_torch.parallel.tensor_parallel import \
                linear_forward
            return linear_forward(self, input,
                                  bound_axis(self.model_parallel))
        return F.linear(input, self.weight, self.bias)


class LookupTable(Module):
    """Embedding lookup (reference ``nn/LookupTable.scala:44``; JAX
    ``nn/linear.py:160``).

    Input indices are 1-based float ids (Torch convention): they are cast
    to integers (truncating), shifted to 0-based and clipped into the
    table, as in the JAX package.  A finite ``max_norm`` renormalises each
    gathered row to at most that ``norm_type``-norm (JAX :186-190: the
    rows are scaled by ``min(1, max_norm / max(norm, 1e-7))``; the table
    itself is not written).  ``padding_value`` and
    ``should_scale_grad_by_freq`` are taken as the JAX package takes them,
    and change nothing there either."""

    def __init__(self, n_index: int, n_output: int, padding_value: float = 0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 w_regularizer=None, device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.should_scale_grad_by_freq = should_scale_grad_by_freq
        self.w_regularizer = w_regularizer
        w = torch.randn(n_index, n_output, generator=make_generator(generator))
        self.weight = nn.Parameter(w.to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        idx = (input.to(torch.int64) - 1).clamp(0, self.n_index - 1)
        out = F.embedding(idx, self.weight)
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(out, ord=self.norm_type,
                                             dim=-1, keepdim=True)
            out = out * torch.clamp(self.max_norm / norms.clamp_min(1e-7),
                                    max=1.0)
        return out


def _uniform(shape, stdv: float, g: torch.Generator) -> torch.Tensor:
    return torch.empty(tuple(shape)).uniform_(-stdv, stdv, generator=g)


class Bilinear(Module):
    """y_k = x1 W_k x2 + b_k over a table [x1 (N, in1), x2 (N, in2)]
    (reference ``nn/Bilinear.scala``), stdv 1/sqrt(in1)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, w_regularizer=None,
                 b_regularizer=None, device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size1 = input_size1
        self.input_size2 = input_size2
        self.output_size = output_size
        self.bias_res = bias_res
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        g = make_generator(generator)
        stdv = 1.0 / math.sqrt(input_size1)
        self.weight = nn.Parameter(_uniform(
            (output_size, input_size1, input_size2), stdv, g).to(device))
        if bias_res:
            self.bias = nn.Parameter(
                _uniform((output_size,), stdv, g).to(device))
        else:
            self.register_parameter("bias", None)

    def forward(self, input) -> torch.Tensor:
        out = torch.einsum("ni,oij,nj->no", input[0], self.weight, input[1])
        return out + self.bias if self.bias is not None else out


class Add(Module):
    """A learnable bias of ``input_size`` (reference ``nn/Add.scala``)."""

    def __init__(self, input_size: int, init_bias=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        b = (torch.as_tensor(init_bias, dtype=torch.float32).reshape(-1)
             .clone() if init_bias is not None
             else _uniform((input_size,), 1.0 / math.sqrt(input_size),
                           make_generator(generator)))
        self.bias = nn.Parameter(b.to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input + self.bias


class Mul(Module):
    """One learnable scalar gain, drawn U(-1, 1) (reference
    ``nn/Mul.scala``)."""

    def __init__(self, device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            _uniform((), 1.0, make_generator(generator)).to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input * self.weight


class CMul(Module):
    """A learnable gain of the broadcastable ``size`` (reference
    ``nn/CMul.scala``), stdv 1/sqrt(its element count)."""

    def __init__(self, size: Sequence[int],
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        stdv = 1.0 / math.sqrt(math.prod(self.size))
        self.weight = nn.Parameter(
            _uniform(self.size, stdv, make_generator(generator)).to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input * self.weight


class CAdd(Module):
    """A learnable bias of the broadcastable ``size`` (reference
    ``nn/CAdd.scala``), stdv 1/sqrt(its element count)."""

    def __init__(self, size: Sequence[int],
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(size)
        stdv = 1.0 / math.sqrt(math.prod(self.size))
        self.bias = nn.Parameter(
            _uniform(self.size, stdv, make_generator(generator)).to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return input + self.bias


class Euclidean(Module):
    """The Euclidean distance from the input to each of ``output_size``
    learnable centres, the columns of an (in, out) weight (reference
    ``nn/Euclidean.scala``); 1e-12 under the root."""

    def __init__(self, input_size: int, output_size: int,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.weight = nn.Parameter(_uniform(
            (input_size, output_size), 1.0 / math.sqrt(input_size),
            make_generator(generator)).to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        x = input[:, :, None] if input.dim() == 2 else input[:, None]
        d = x - self.weight
        return torch.sqrt((d * d).sum(dim=-2) + 1e-12)


class Cosine(Module):
    """The cosine similarity of the input to each of ``output_size``
    learnable centres, the columns of an (in, out) weight, each norm
    floored at 1e-12 (reference ``nn/Cosine.scala``)."""

    def __init__(self, input_size: int, output_size: int,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.weight = nn.Parameter(_uniform(
            (input_size, output_size), 1.0 / math.sqrt(input_size),
            make_generator(generator)).to(device))

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        w = self.weight
        xn = input / torch.clamp(torch.linalg.vector_norm(
            input, dim=-1, keepdim=True), min=1e-12)
        wn = w / torch.clamp(torch.linalg.vector_norm(
            w, dim=0, keepdim=True), min=1e-12)
        return xn @ wn
