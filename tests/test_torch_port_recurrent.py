"""The port's recurrent stack (``nn/recurrent.py``), held against the JAX
package's on the CPU.

Each layer is built in both packages.  The JAX parameter tree is filled
from a numpy seed (shapes from ``jax.eval_shape``) and carried into the
port with ``params_from_jax``; inputs come from numpy seeds.  Gradients are
taken of ``sum(out * r)`` for a fixed numpy ``r``, with ``jax.grad`` on the
JAX side and autograd here, and read back in the JAX layout.

Tolerances: fp32 outputs within atol 1e-5 (the same sums in other
orders); gradients of parameters and input within atol 1e-4.

Dropout in ``LSTM``/``GRU`` (p > 0) cannot match the JAX package's masks
(threefry bits against torch's generator), so its cases check what the
masks must be: the kept fraction within binomial bounds, kept inputs scaled
by 1/(1 - p), the same masks from the same generator seed, the identity in
eval mode and without a random stream.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.utils import convert
from bigdl_tpu_torch.utils.convert import params_from_jax, params_to_jax

ATOL = 1e-5
GRAD_ATOL = 1e-4
B, T = 3, 5


def numpy_params(jm, seed, scale=0.5):
    """``jm``'s parameter tree, each leaf U(-scale, scale) from a numpy
    seed, float32."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: rng.uniform(-scale, scale, s.shape).astype(np.float32),
        shapes)


def pair(jm, pm, seed=0):
    """The JAX tree from ``seed``, carried into the port module."""
    params = numpy_params(jm, seed)
    params_from_jax(params, pm)
    return params


def port_grads(pm):
    """The port's parameter gradients as a tree in the JAX layout."""
    return convert._dump(pm, lambda m: {
        k: p.grad for k, p in m.named_parameters(recurse=False)})


def assert_trees_close(port_tree, jax_tree, atol):
    pl, jl = (jax.tree_util.tree_leaves(t) for t in (port_tree, jax_tree))
    assert len(pl) == len(jl) and pl
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p, np.asarray(j), atol=atol, rtol=0)


def check_against_jax(jm, pm, x, seed=0):
    """Output, parameter gradients and input gradient of ``pm`` against
    ``jm`` for the numpy input ``x`` (or a list of inputs, of which the
    first is differentiated); returns the port's output."""
    params = pair(jm, pm, seed)
    xs = x if isinstance(x, list) else [x]
    state = jm._init_state()

    def jax_input(x0):
        return [x0] + [jnp.asarray(a) for a in xs[1:]] if len(xs) > 1 \
            else x0

    x0 = torch.from_numpy(xs[0]).requires_grad_(True)
    out = pm([x0] + [torch.from_numpy(a) for a in xs[1:]] if len(xs) > 1
             else x0)
    r = np.random.default_rng(seed + 100).normal(
        size=tuple(out.shape)).astype(np.float32)

    def loss(p, x0, r):
        out = jm.apply(p, jax_input(x0), state)[0]
        return jnp.sum(out * r), out

    # one compile for the output and both gradients
    (_, ref), (jgrad, jx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs[0]), r)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=0)
    (out * torch.from_numpy(r)).sum().backward()
    assert_trees_close(port_grads(pm), jgrad, GRAD_ATOL)
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(jx),
                               atol=GRAD_ATOL, rtol=0)
    return out


def cell_pair(kind):
    """(JAX cell, port cell, input shape) for each cell kind."""
    D, H = 4, 6
    if kind == "rnn_tanh":
        return jnn.RnnCell(D, H, jnn.Tanh()), pnn.RnnCell(D, H, pnn.Tanh()), \
            (B, T, D)
    if kind == "rnn_relu":
        return jnn.RnnCell(D, H, jnn.ReLU()), pnn.RnnCell(D, H, pnn.ReLU()), \
            (B, T, D)
    if kind == "lstm":
        return jnn.LSTM(D, H), pnn.LSTM(D, H), (B, T, D)
    if kind == "lstm_peephole":
        return jnn.LSTMPeephole(D, H), pnn.LSTMPeephole(D, H), (B, T, D)
    if kind == "gru":
        return jnn.GRU(D, H), pnn.GRU(D, H), (B, T, D)
    if kind == "conv_lstm_odd":
        return (jnn.ConvLSTMPeephole(2, 3, 3, 3),
                pnn.ConvLSTMPeephole(2, 3, 3, 3), (B, T, 2, 5, 6))
    if kind == "conv_lstm_even":
        return (jnn.ConvLSTMPeephole(2, 3, 2, 4),
                pnn.ConvLSTMPeephole(2, 3, 2, 4), (B, T, 2, 5, 6))
    if kind == "conv_lstm_3d":
        return (jnn.ConvLSTMPeephole3D(2, 3, 3, 3),
                pnn.ConvLSTMPeephole3D(2, 3, 3, 3), (B, T, 2, 3, 4, 4))
    raise ValueError(kind)


CELLS = ["rnn_tanh", "rnn_relu", "lstm", "lstm_peephole", "gru",
         "conv_lstm_odd", "conv_lstm_even", "conv_lstm_3d"]


@pytest.mark.parametrize("kind", CELLS)
def test_cell_in_recurrent_matches_jax(kind):
    jc, pc, shape = cell_pair(kind)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jm, pm = jnn.Recurrent().add(jc), pnn.Recurrent().add(pc)
    out = check_against_jax(jm, pm, x)
    assert out.shape[:2] == (B, T)
    # the last hidden state is kept, detached, with the hidden's structure
    h = pm.get_hidden_state()
    hs = h if isinstance(h, tuple) else (h,)
    assert isinstance(h, tuple) == pc.hidden_is_tuple
    assert all(not t.requires_grad for t in hs)
    torch.testing.assert_close(hs[0], out[:, -1].detach(), rtol=0, atol=0)


def test_conv_lstm_ignores_stride_and_keeps_the_map_size():
    """``stride`` is accepted and ignored, as the JAX package ignores it
    (its convolutions' window strides are all 1): the cell at stride 2
    computes what it computes at stride 1, and the hidden map keeps the
    input's spatial size."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, 2, 5, 6, generator=g)
    one = pnn.Recurrent().add(pnn.ConvLSTMPeephole(2, 3, 3, 3, stride=1))
    two = pnn.Recurrent().add(copy.deepcopy(one.cell))
    two.cell.stride = 2
    with torch.no_grad():
        out = two(x)
        torch.testing.assert_close(out, one(x), rtol=0, atol=0)
    assert out.shape == (2, 3, 3, 5, 6)


def test_conv_lstm_without_peephole_matches_jax():
    jm = jnn.Recurrent().add(jnn.ConvLSTMPeephole(2, 3, with_peephole=False))
    pm = pnn.Recurrent().add(pnn.ConvLSTMPeephole(2, 3, with_peephole=False))
    assert sorted(dict(pm.cell.named_parameters())) == [
        "bias", "w_hh", "w_ih"]
    x = np.random.default_rng(3).normal(size=(2, 3, 2, 4, 4)).astype(
        np.float32)
    check_against_jax(jm, pm, x)


def test_conv_lstm_hidden_needs_a_forward():
    with pytest.raises(RuntimeError, match="first forward"):
        pnn.ConvLSTMPeephole(2, 3).init_hidden(2)


def test_parameter_layouts_round_trip():
    """The cells keep the JAX layout, (in, k*H) and (H, k*H); the ConvLSTM
    kernels stay OIHW/OIDHW and the peepholes (H, 1, ...); both directions
    of the conversion give the JAX tree back bit for bit."""
    for kind in CELLS:
        jc, pc, _ = cell_pair(kind)
        jm, pm = jnn.Recurrent().add(jc), pnn.Recurrent().add(pc)
        params = pair(jm, pm, seed=4)
        back = params_to_jax(pm)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(params)):
            assert a.shape == b.shape and np.array_equal(a, b)
    conv = pnn.ConvLSTMPeephole3D(2, 3, 3, 5)
    assert conv.w_ih.shape == (12, 2, 3, 3, 3)
    assert conv.w_hh.shape == (12, 3, 5, 5, 5)
    assert conv.w_ci.shape == (3, 1, 1, 1)
    assert pnn.LSTM(4, 6).w_ih.shape == (4, 24)
    assert pnn.LSTMPeephole(4, 6).w_co.shape == (6,)


@pytest.mark.parametrize("merge", ["add", "concat"])
def test_birecurrent_matches_jax(merge):
    jm = jnn.BiRecurrent(merge).add(jnn.LSTM(4, 6))
    pm = pnn.BiRecurrent(merge).add(pnn.LSTM(4, 6))
    assert len(pm) == 2
    x = np.random.default_rng(5).normal(size=(B, T, 4)).astype(np.float32)
    out = check_against_jax(jm, pm, x, seed=6)
    assert out.shape == (B, T, 6 if merge == "add" else 12)


def test_birecurrent_clones_the_cell_with_its_parameters():
    cell = pnn.GRU(4, 6, generator=torch.Generator().manual_seed(3))
    bi = pnn.BiRecurrent().add(cell)
    fwd, bwd = bi.layers[0], bi.layers[1]
    assert fwd is cell and bwd is not cell
    for (na, a), (nb, b) in zip(fwd.named_parameters(),
                                bwd.named_parameters()):
        assert na == nb and torch.equal(a, b) and a is not b


@pytest.mark.parametrize("inner", ["linear", "logsoftmax"])
def test_time_distributed_matches_jax(inner):
    if inner == "linear":
        jm = jnn.TimeDistributed(jnn.Linear(4, 7))
        pm = pnn.TimeDistributed(pnn.Linear(4, 7))
    else:
        jm = jnn.TimeDistributed(jnn.LogSoftMax())
        pm = pnn.TimeDistributed(pnn.LogSoftMax())
    x = np.random.default_rng(7).normal(size=(B, T, 4)).astype(np.float32)
    if inner == "linear":
        check_against_jax(jm, pm, x)
    else:
        ref, _ = jm.apply([{}], jnp.asarray(x), [{}])
        np.testing.assert_allclose(pm(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref), atol=ATOL, rtol=0)


def test_hidden_state_set_and_get_match_jax():
    """``set_hidden_state`` starts every later forward from the given
    state; ``get_hidden_state`` is the state after the last forward."""
    jm, pm = jnn.Recurrent().add(jnn.LSTM(4, 6)), \
        pnn.Recurrent().add(pnn.LSTM(4, 6))
    params = pair(jm, pm, seed=8)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, T, 4)).astype(np.float32)
    h0 = tuple(rng.normal(size=(B, 6)).astype(np.float32) for _ in range(2))
    jm.set_hidden_state(tuple(jnp.asarray(h) for h in h0))
    pm.set_hidden_state(tuple(torch.from_numpy(h) for h in h0))
    ref, _ = jm.apply(params, jnp.asarray(x), [{}])
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    for got, want in zip(pm.get_hidden_state(), jm.get_hidden_state()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)
    # from zeros the result differs
    with torch.no_grad():
        zero_start = pnn.Recurrent().add(copy.deepcopy(pm.cell))(
            torch.from_numpy(x))
    assert not torch.allclose(zero_start, out)


@pytest.mark.parametrize("kind", ["rnn_tanh", "lstm", "gru"])
def test_standalone_cell_table_call_matches_jax(kind):
    """A cell called alone maps [x_t, hidden] to [out, hidden']."""
    jc, pc, shape = cell_pair(kind)
    params = pair(jc, pc, seed=10)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, shape[-1])).astype(np.float32)
    h = rng.normal(size=(B, 6)).astype(np.float32)
    hidden_j = (jnp.asarray(h), jnp.asarray(h * 0.5)) if \
        jc.hidden_is_tuple else jnp.asarray(h)
    hidden_p = (torch.from_numpy(h), torch.from_numpy(h * 0.5)) if \
        pc.hidden_is_tuple else torch.from_numpy(h)
    (ref_out, ref_h), _ = jc.apply(params, [jnp.asarray(x), hidden_j], {})
    with torch.no_grad():
        out, new_h = pc([torch.from_numpy(x), hidden_p])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL,
                               rtol=0)
    for got, want in zip(jax.tree_util.tree_leaves(
            [t.numpy() for t in (new_h if isinstance(new_h, tuple)
                                 else (new_h,))]),
            jax.tree_util.tree_leaves(ref_h)):
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def left_leaning(n_leaves, used=None, pad_front=0):
    """A left-leaning tree over the first ``used`` leaves (all by
    default), behind ``pad_front`` rows of -1; node ``n_leaves + j`` is
    row j, so the root is the last row."""
    nodes, cur = [[-1, -1]] * pad_front, 0
    for leaf in range(1, used or n_leaves):
        nodes.append([cur, leaf])
        cur = n_leaves + len(nodes) - 1
    return nodes


def balanced(n_leaves, used=None):
    """A balanced tree over the first ``used`` leaves (a power of two),
    level by level."""
    level, nodes = list(range(used or n_leaves)), []
    while len(level) > 1:
        up = []
        for a, b in zip(level[0::2], level[1::2]):
            nodes.append([a, b])
            up.append(n_leaves + len(nodes) - 1)
        level = up
    return nodes


def tree_batch(n_leaves=8):
    """Four trees over ``n_leaves`` leaves: left-leaning, balanced, a
    smaller one behind -1 rows (its root stays last), and a smaller one
    followed by -1 rows."""
    half = n_leaves // 2
    trees = [left_leaning(n_leaves), balanced(n_leaves),
             left_leaning(n_leaves, half, n_leaves - half),
             balanced(n_leaves, half) + [[-1, -1]] * (n_leaves - half)]
    return np.asarray(trees, np.int32)


class _HostReads(TorchDispatchMode):
    """Records every operator that reads a tensor's value on the host."""

    READS = ("_local_scalar_dense", "nonzero", "is_nonzero", "equal",
             "item")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(r in name for r in self.READS):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def dropout_cell(kind, p):
    g = torch.Generator().manual_seed(0)
    return (pnn.LSTM(40, 8, p=p, generator=g) if kind == "lstm"
            else pnn.GRU(40, 8, p=p, generator=g))
