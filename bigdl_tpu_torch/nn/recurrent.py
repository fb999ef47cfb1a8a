"""The recurrent stack (``bigdl_tpu/nn/recurrent.py``: ``Cell`` :51,
``RnnCell`` :86, ``LSTM`` :122, ``LSTMPeephole`` :182, ``GRU`` :210,
``ConvLSTMPeephole`` :257, ``ConvLSTMPeephole3D`` :350, ``Recurrent`` :356,
``BiRecurrent`` :421, ``TimeDistributed`` :470, ``BinaryTreeLSTM`` :489;
reference ``nn/Cell.scala:44``, ``nn/Recurrent.scala:33``,
``nn/BiRecurrent.scala:33``, ``nn/TimeDistributed.scala:40``,
``nn/BinaryTreeLSTM.scala:36``).

A cell has the JAX package's three parts: :meth:`Cell.init_hidden`, the
zero hidden state; :meth:`Cell.project_input`, the time-independent input
projection over all T steps at once (one GEMM over the (B*T, D) rows, the
reference's ``preTopology``); and :meth:`Cell.step`, one recurrence step on
a projected timestep.  The JAX package unrolls time with one ``lax.scan``;
here :class:`Recurrent` runs a Python loop over T that calls ``step`` and
stacks the outputs on dim 1, and autograd records back-propagation through
time.  Input is batch-first, (B, T, features...).

Weight layout: the cells and ``BinaryTreeLSTM`` keep the JAX package's
layout, input-major, ``w_ih`` (in, k*H) and ``w_hh`` (H, k*H) (k gates
side by side: LSTM's i, f, g, o; GRU's r, z, n), so that a step is
``proj_t + h @ w_hh`` and
:func:`~bigdl_tpu_torch.utils.convert.params_from_jax` copies them as they
are (``Linear`` alone transposes to torch's (out, in)).
``ConvLSTMPeephole``'s kernels are OIHW (OIDHW in 3-D) in both packages,
torch's own convolution layout, and its peephole vectors are (H, 1, 1)
((H, 1, 1, 1)); ``LSTMPeephole``'s are (H,).

The hidden state follows the dtype of ``w_hh``, so in a bf16
``mixed_precision_forward`` (whose parameters are cast down) the
recurrent products stay in bf16.  Activations are elementwise: a port
module (``Tanh()``, ``Sigmoid()``) or a function of a tensor.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Container, Module, make_generator


def _uniform(shape, stdv: float, generator: torch.Generator,
             device) -> nn.Parameter:
    """U(-stdv, stdv), drawn on the CPU from ``generator`` and moved."""
    w = torch.empty(tuple(shape)).uniform_(-stdv, stdv, generator=generator)
    return nn.Parameter(w.to(device))


def _project(x: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` over the last dim of ``x``: one GEMM over all its
    rows, the bias added in the GEMM's epilogue."""
    rows = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return rows.view(tuple(x.shape[:-1]) + (w.shape[1],))


class Cell(Module):
    """Base class of the recurrent cells (reference ``nn/Cell.scala:44``).

    Called on its own, a cell has the reference's Table semantics
    ``[x_t, hidden] -> [output_t, hidden']``, with ``x_t`` one timestep
    (B, features...)."""

    hidden_is_tuple = False

    def init_hidden(self, batch: int):
        """The zero hidden state of ``batch`` rows."""
        raise NotImplementedError(type(self).__name__)

    def project_input(self, x: torch.Tensor) -> torch.Tensor:
        """The input projection of (B, T, ...) ``x``, all steps at once;
        the identity by default."""
        return x

    def step(self, proj_t: torch.Tensor, hidden):
        """One step: (projected input_t, hidden) -> (output_t, hidden')."""
        raise NotImplementedError(type(self).__name__)

    def forward(self, input):
        x_t, hidden = input[0], input[1]
        proj = self.project_input(x_t.unsqueeze(1))[:, 0]
        out, new_hidden = self.step(proj, hidden)
        return [out, new_hidden]

    def _zeros(self, batch: int, *trailing) -> torch.Tensor:
        w = self.w_hh
        return torch.zeros((batch,) + tuple(trailing), dtype=w.dtype,
                           device=w.device)


class _InputDropout:
    """``p`` > 0 on LSTM and GRU: in training, the input is dropped before
    its projection, with the masks of all T steps drawn at once from the
    module's random stream (:func:`~bigdl_tpu_torch.nn.module.
    random_stream`) and the kept elements scaled by 1 / (1 - p).  The
    identity in eval mode and without a stream, as the JAX package's cells
    are with ``rng=None``.  The bits are torch's, not JAX's threefry."""

    @property
    def stochastic(self) -> bool:
        return self.p > 0

    def _drop(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0 or self.generator is None:
            return x
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * (mask / keep)


class RnnCell(Cell):
    """Vanilla RNN cell, h' = act(x W_ih + b + h W_hh) (reference
    ``nn/RNN.scala``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        g = make_generator(generator)
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_ih = _uniform((input_size, hidden_size), stdv, g, device)
        self.w_hh = _uniform((hidden_size, hidden_size), stdv, g, device)
        self.bias = _uniform((hidden_size,), stdv, g, device)

    def init_hidden(self, batch: int) -> torch.Tensor:
        return self._zeros(batch, self.hidden_size)

    def project_input(self, x: torch.Tensor) -> torch.Tensor:
        return _project(x, self.w_ih, self.bias)

    def step(self, proj_t, hidden):
        h = self.activation(torch.addmm(proj_t, hidden, self.w_hh))
        return h, h


class LSTM(_InputDropout, Cell):
    """LSTM cell, gates (i, f, g, o) from one fused (D, 4H) projection
    (reference ``nn/LSTM.scala:50``).  ``p``: dropout on the input before
    the projection (see :class:`_InputDropout`)."""

    hidden_is_tuple = True

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation=torch.tanh, inner_activation=torch.sigmoid,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p
        self.activation = activation
        self.inner_activation = inner_activation
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self.generator: Optional[torch.Generator] = None
        g = make_generator(generator)
        H = hidden_size
        stdv = 1.0 / math.sqrt(H)
        self.w_ih = _uniform((input_size, 4 * H), stdv, g, device)
        self.w_hh = _uniform((H, 4 * H), stdv, g, device)
        self.bias = _uniform((4 * H,), stdv, g, device)

    def init_hidden(self, batch: int):
        z = self._zeros(batch, self.hidden_size)
        return (z, z)

    def project_input(self, x: torch.Tensor) -> torch.Tensor:
        return _project(self._drop(x), self.w_ih, self.bias)

    def step(self, proj_t, hidden):
        h, c = hidden
        H = self.hidden_size
        z = torch.addmm(proj_t, h, self.w_hh)
        # one launch for the three gates (elementwise: the g block's
        # values are computed and not read)
        s = self.inner_activation(z)
        i, f, o = s[:, 0:H], s[:, H:2 * H], s[:, 3 * H:4 * H]
        g = self.activation(z[:, 2 * H:3 * H])
        c2 = torch.addcmul(f * c, i, g)
        h2 = o * self.activation(c2)
        return h2, (h2, c2)


class LSTMPeephole(LSTM):
    """LSTM with peephole connections from the cell state into the gates
    (reference ``nn/LSTMPeephole.scala``): ``w_ci``, ``w_cf``, ``w_co``,
    each (H,)."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation=torch.tanh, inner_activation=torch.sigmoid,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        g = make_generator(generator)
        super().__init__(input_size, hidden_size, p, activation,
                         inner_activation, w_regularizer, u_regularizer,
                         b_regularizer, device, g)
        H = hidden_size
        stdv = 1.0 / math.sqrt(H)
        self.w_ci = _uniform((H,), stdv, g, device)
        self.w_cf = _uniform((H,), stdv, g, device)
        self.w_co = _uniform((H,), stdv, g, device)

    def step(self, proj_t, hidden):
        h, c = hidden
        H = self.hidden_size
        act, inner = self.activation, self.inner_activation
        z = torch.addmm(proj_t, h, self.w_hh)
        i = inner(z[:, 0:H] + c * self.w_ci)
        f = inner(z[:, H:2 * H] + c * self.w_cf)
        g = act(z[:, 2 * H:3 * H])
        c2 = torch.addcmul(f * c, i, g)
        o = inner(z[:, 3 * H:4 * H] + c2 * self.w_co)
        h2 = o * act(c2)
        return h2, (h2, c2)


class GRU(_InputDropout, Cell):
    """GRU cell, gates (r, z) and candidate n, with input and hidden biases
    apart (reference ``nn/GRU.scala:54``).  ``p`` as :class:`LSTM`'s."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self.generator: Optional[torch.Generator] = None
        g = make_generator(generator)
        H = hidden_size
        stdv = 1.0 / math.sqrt(H)
        self.w_ih = _uniform((input_size, 3 * H), stdv, g, device)
        self.w_hh = _uniform((H, 3 * H), stdv, g, device)
        self.b_ih = _uniform((3 * H,), stdv, g, device)
        self.b_hh = _uniform((3 * H,), stdv, g, device)

    def init_hidden(self, batch: int) -> torch.Tensor:
        return self._zeros(batch, self.hidden_size)

    def project_input(self, x: torch.Tensor) -> torch.Tensor:
        return _project(self._drop(x), self.w_ih, self.b_ih)

    def step(self, proj_t, hidden):
        H = self.hidden_size
        hz = torch.addmm(self.b_hh, hidden, self.w_hh)
        rz = torch.sigmoid(proj_t[:, 0:2 * H] + hz[:, 0:2 * H])
        r, z = rz[:, 0:H], rz[:, H:2 * H]
        n = torch.tanh(proj_t[:, 2 * H:] + r * hz[:, 2 * H:])
        h2 = (1.0 - z) * n + z * hidden
        return h2, h2


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM with peepholes over NCHW maps (reference
    ``nn/ConvLSTMPeephole.scala``): input (B, T, C, H, W).

    All four gates come from one convolution with 4 * ``output_size``
    output channels, ``w_ih`` (4H, C, k_i, k_i) over the input and ``w_hh``
    (4H, H, k_c, k_c) over the hidden map.  The padding is XLA's ``SAME``:
    (k - 1) // 2 before and k // 2 after, so an even kernel pads one more
    on the high side.  ``stride`` is kept for the reference's signature
    and ignored, as the JAX package ignores it: every window stride is 1,
    and the maps keep their size.  The spatial shape binds at the first
    forward."""

    hidden_is_tuple = True
    _spatial_dims = 2

    def __init__(self, input_size: int, output_size: int,
                 kernel_i: int = 3, kernel_c: int = 3, stride: int = 1,
                 with_peephole: bool = True,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.kernel_i = kernel_i
        self.kernel_c = kernel_c
        self.stride = stride
        self.with_peephole = with_peephole
        self._spatial_shape: Optional[tuple] = None
        g = make_generator(generator)
        H, C, nd = output_size, input_size, self._spatial_dims
        stdv = 1.0 / math.sqrt(C * kernel_i ** nd)
        self.w_ih = _uniform((4 * H, C) + (kernel_i,) * nd, stdv, g, device)
        self.w_hh = _uniform((4 * H, H) + (kernel_c,) * nd, stdv, g, device)
        self.bias = _uniform((4 * H,), stdv, g, device)
        if with_peephole:
            ones = (1,) * nd
            self.w_ci = _uniform((H,) + ones, stdv, g, device)
            self.w_cf = _uniform((H,) + ones, stdv, g, device)
            self.w_co = _uniform((H,) + ones, stdv, g, device)

    def _conv(self, x: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = F.conv2d if self._spatial_dims == 2 else F.conv3d
        k = w.shape[-1]
        lo, hi = (k - 1) // 2, k // 2
        if lo == hi:
            return conv(x, w, bias, padding=lo)
        return conv(F.pad(x, (lo, hi) * self._spatial_dims), w, bias)

    def init_hidden(self, batch: int):
        if self._spatial_shape is None:
            raise RuntimeError("ConvLSTMPeephole hidden spatial shape unknown "
                               "before the first forward")
        z = self._zeros(batch, self.output_size, *self._spatial_shape)
        return (z, z)

    def project_input(self, x: torch.Tensor) -> torch.Tensor:
        # (B, T, C, *spatial): T folds into the batch for one convolution
        B, T = x.shape[0], x.shape[1]
        self._spatial_shape = tuple(x.shape[3:])
        out = self._conv(x.reshape((B * T,) + tuple(x.shape[2:])),
                         self.w_ih, self.bias)
        return out.reshape((B, T) + tuple(out.shape[1:]))

    def step(self, proj_t, hidden):
        h, c = hidden
        H = self.output_size
        z = proj_t + self._conv(h, self.w_hh)
        zi, zf, zg, zo = (z[:, 0:H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                          z[:, 3 * H:4 * H])
        if self.with_peephole:
            zi = zi + c * self.w_ci
            zf = zf + c * self.w_cf
        i = torch.sigmoid(zi)
        f = torch.sigmoid(zf)
        g = torch.tanh(zg)
        c2 = f * c + i * g
        if self.with_peephole:
            zo = zo + c2 * self.w_co
        o = torch.sigmoid(zo)
        h2 = o * torch.tanh(c2)
        return h2, (h2, c2)


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """The 3-D variant over NCDHW maps, input (B, T, C, D, H, W)
    (reference ``nn/ConvLSTMPeephole3D.scala``)."""

    _spatial_dims = 3


def _unroll(cell: Cell, x: torch.Tensor, hidden=None):
    """The cell over the T steps of (B, T, ...) ``x`` from ``hidden``
    (zeros by default, made after the projection, which binds a
    ``ConvLSTMPeephole``'s spatial shape): the outputs stacked on dim 1,
    and the last hidden state."""
    proj = cell.project_input(x)
    if hidden is None:
        hidden = cell.init_hidden(x.shape[0])
    outs = []
    # time-major and contiguous once, so each step's slice is contiguous
    for proj_t in proj.transpose(0, 1).contiguous().unbind(0):
        out, hidden = cell.step(proj_t, hidden)
        outs.append(out)
    return torch.stack(outs, 1), hidden


class Recurrent(Container):
    """The time unroll of one cell (reference ``nn/Recurrent.scala:33``):
    ``add(cell)``, then forward a (B, T, features...) batch; the output is
    the cell's per-step output stacked back to (B, T, ...)."""

    def __init__(self):
        super().__init__()
        self._last_hidden = None
        self._init_hidden_override = None

    def add(self, module: nn.Module) -> "Recurrent":
        if not isinstance(module, Cell):
            raise ValueError("Recurrent accepts a Cell, got "
                             f"{type(module).__name__}")
        if len(self.layers):
            raise ValueError("Recurrent holds exactly one Cell")
        return super().add(module)

    @property
    def cell(self) -> Cell:
        return self.layers[0]

    def set_hidden_state(self, hidden) -> "Recurrent":
        """The hidden state every later forward starts from, in place of
        zeros (reference ``Recurrent.setHiddenState``)."""
        self._init_hidden_override = hidden
        return self

    def get_hidden_state(self):
        """The hidden state after the last forward (reference
        ``Recurrent.getHiddenState``), detached, so that it does not hold
        that forward's graph alive."""
        return self._last_hidden

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        out, h = _unroll(self.cell, input, self._init_hidden_override)
        self._last_hidden = tuple(t.detach() for t in h) if \
            isinstance(h, tuple) else h.detach()
        return out


class BiRecurrent(Container):
    """Bidirectional unroll (reference ``nn/BiRecurrent.scala:33``): the
    cell forward over time and its clone, made at ``add`` with the same
    initial parameters, over the time-reversed input; the outputs, the
    reverse one flipped back, merge by ``"add"`` (the reference's
    ``CAddTable``) or ``"concat"`` on the last dim."""

    def __init__(self, merge: str = "add"):
        super().__init__()
        if merge not in ("add", "concat"):
            raise ValueError(f"merge must be add|concat, got {merge}")
        self.merge = merge

    def add(self, module: nn.Module) -> "BiRecurrent":
        if not isinstance(module, Cell):
            raise ValueError("BiRecurrent accepts a Cell")
        if len(self.layers) >= 2:
            raise ValueError("BiRecurrent holds forward and reverse cells "
                             "only")
        super().add(module)
        if len(self.layers) == 1:
            super().add(copy.deepcopy(module))
        return self

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        fwd, bwd = self.layers[0], self.layers[1]
        out_f, _ = _unroll(fwd, input)
        out_b = _unroll(bwd, input.flip(1))[0].flip(1)
        if self.merge == "add":
            return out_f + out_b
        return torch.cat([out_f, out_b], -1)


class TimeDistributed(Container):
    """The wrapped layer at every timestep (reference
    ``nn/TimeDistributed.scala:40``): T folds into the batch, so the layer
    sees one (B*T, ...) batch."""

    def __init__(self, layer: Optional[nn.Module] = None):
        super().__init__()
        if layer is not None:
            self.add(layer)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        B, T = input.shape[0], input.shape[1]
        out = self.layers[0](input.reshape((B * T,) + tuple(input.shape[2:])))
        return out.reshape((B, T) + tuple(out.shape[1:]))


class BinaryTreeLSTM(Module):
    """Binary constituency TreeLSTM (reference
    ``nn/BinaryTreeLSTM.scala:36``), the tree as data: input
    ``[emb (B, L, D), tree (B, n, 2) int]``, where node i < L is leaf i
    and row j of ``tree`` holds the child indices of node L + j, children
    before parents (topological order).  A row with a -1 child is an
    invalid node (padding): its h and c are zero.  Output: the internal
    nodes' hiddens (B, n, H), in the tree's order.

    The leaves take one fused (D, 3H) projection (gates i, o, u); each
    internal node one (2H, 5H) composer over [h_left, h_right] (gates i,
    f_left, f_right, o, u).  The node loop gathers both children's h and c
    from one (B, L + n, 2H) buffer on the device, with no host read, and
    writes the new node by ``torch.where`` over its one-hot slot (the JAX
    package blends with the one-hot), out of place, as autograd needs."""

    def __init__(self, input_size: int, hidden_size: int,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = make_generator(generator)
        D, H = input_size, hidden_size
        stdv = 1.0 / math.sqrt(H)
        self.w_leaf = _uniform((D, 3 * H), stdv, g, device)
        self.b_leaf = _uniform((3 * H,), stdv, g, device)
        self.w_comp = _uniform((2 * H, 5 * H), stdv, g, device)
        self.b_comp = _uniform((5 * H,), stdv, g, device)

    def forward(self, input) -> torch.Tensor:
        emb, tree = input[0], input[1]
        B, L = emb.shape[0], emb.shape[1]
        n, H = tree.shape[1], self.hidden_size
        N = L + n
        z = _project(emb, self.w_leaf, self.b_leaf)
        io = torch.sigmoid(z[..., 0:2 * H])
        u = torch.tanh(z[..., 2 * H:])
        c_leaf = io[..., 0:H] * u
        h_leaf = io[..., H:] * torch.tanh(c_leaf)
        buf = torch.cat([torch.cat([h_leaf, c_leaf], -1),
                         h_leaf.new_zeros(B, n, 2 * H)], 1)
        tree = tree.to(device=emb.device, dtype=torch.long)
        valid = ((tree[..., 0] >= 0) & (tree[..., 1] >= 0)).to(
            buf.dtype).unsqueeze(-1)
        idx = tree.clamp(min=0).unsqueeze(-1).expand(B, n, 2, 2 * H)
        slot = torch.eye(N, dtype=torch.bool, device=emb.device)[L:, :, None]
        outs = []
        for j in range(n):
            ch = buf.gather(1, idx[:, j])                  # (B, 2, 2H)
            zc = torch.addmm(self.b_comp, ch[..., 0:H].reshape(B, 2 * H),
                             self.w_comp)
            gates = torch.sigmoid(zc[:, 0:4 * H])
            ug = torch.tanh(zc[:, 4 * H:])
            ig, fl = gates[:, 0:H], gates[:, H:2 * H]
            fr, og = gates[:, 2 * H:3 * H], gates[:, 3 * H:]
            c_new = ig * ug + fl * ch[:, 0, H:] + fr * ch[:, 1, H:]
            h_new = og * torch.tanh(c_new)
            hc = torch.cat([h_new, c_new], -1) * valid[:, j]
            buf = torch.where(slot[j], hc[:, None, :], buf)
            outs.append(hc[:, 0:H])
        return torch.stack(outs, 1)


TreeLSTM = BinaryTreeLSTM
