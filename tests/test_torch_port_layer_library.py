"""The port's Torch-style layer library held against the JAX package's, on
the CPU.

Every class of the library has a case: the same constructor arguments in
both packages, inputs from a numpy seed, parameters drawn with numpy into
the JAX tree (shapes from ``jax.eval_shape``, no JAX draw compiled) and
carried over with ``params_from_jax``.  The JAX side runs eagerly: its
module's ``apply`` and ``jax.vjp``; the port's forward and
``torch.autograd.grad``.  Forward output, input gradient and parameter
gradients agree:

- structural and table layers exactly, over small integers (every sum and
  product exact in float32, so that the two libraries' summation orders
  cannot show);
- elementwise maps, the linear family and the initialisers within rtol
  1e-6 (atol 1e-7 for entries near zero);
- criterions within rtol 1e-5.

The stochastic layers (``RReLU``, ``GaussianDropout``, ``GaussianNoise``,
``Dropout``) agree exactly in eval mode; in training their noise has the
stated mean and variance, and the shell's ``backward`` differentiates the
draw its ``update_output`` made.  ``MsraFiller`` has its standard
deviation; ``Ones``, ``ConstInitMethod`` and ``BilinearFiller`` are exact.

The imperative shell: a ``Sequential`` of ``Linear``, ``PReLU``,
``BatchNormalization``, ``Dropout`` (p = 0: torch's and JAX's masks differ
in their bits), ``Linear`` and ``LogSoftMax`` trained 3 steps of
``zero_grad_parameters`` / ``update_output`` / the criterion's
``forward``/``backward`` / ``backward`` / ``update_parameters`` in both
packages: weights and running statistics within 1e-6, and
``get_parameters()`` the same flat vectors in the same order.
``update_grad_input`` leaves the gradients alone, two
``acc_grad_parameters`` give twice one, ``scale_w``/``scale_b`` scale as
the JAX shell scales.  ``Graph``: two inputs, a split, a join and two
outputs against the JAX ``Graph``, outputs and gradients within 1e-6 (its
three matrix products sum in the libraries' own orders); the shell's
``backward`` through it gives autograd's gradients; a cycle raises
``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.nn.module import random_stream
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_to_jax)

EXACT, ELEMENTWISE, CRITERION, GRAPH = ("exact", "elementwise",
                                        "criterion", "graph")
TOL = {ELEMENTWISE: dict(rtol=1e-6, atol=1e-7),
       CRITERION: dict(rtol=1e-5, atol=1e-7),
       GRAPH: dict(rtol=1e-6, atol=1e-6)}


def ints(*shape, lo=-4, hi=5, seed=0):
    """Small integers as float32: exact sums and products."""
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def ids(*shape, n, seed=0):
    """1-based float ids in [1, n] (the lookup layers' Torch convention)."""
    return np.random.default_rng(seed).integers(1, n + 1, shape).astype(
        np.float32)


def normal(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def positive(*shape, seed=0):
    return np.random.default_rng(seed).uniform(0.2, 2.0, shape).astype(
        np.float32)


def jax_params(jm, seed):
    """The JAX module's parameter tree, drawn with numpy N(0, 0.5) (small
    integers for an exact case)."""
    rng = np.random.default_rng(seed + 100)
    shapes = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def exact_params(jm, seed):
    rng = np.random.default_rng(seed + 100)
    shapes = jax.eval_shape(jm._init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda s: rng.integers(-3, 4, s.shape).astype(np.float32), shapes)


def to_torch(tree, grad=True):
    if isinstance(tree, (list, tuple)):
        return [to_torch(t, grad) for t in tree]
    t = torch.from_numpy(np.array(tree))
    return t.requires_grad_(grad and t.is_floating_point())


def leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def check(a, b, kind, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if kind == EXACT:
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, err_msg=what, **TOL[kind])


# (case id, class name, constructor args, input maker, tolerance)
MODULE_CASES = [
    # activations
    ("ReLU6", "ReLU6", (), lambda: normal(3, 5, scale=5), ELEMENTWISE),
    ("LeakyReLU", "LeakyReLU", (0.1,), lambda: normal(3, 5), ELEMENTWISE),
    ("ELU", "ELU", (0.7,), lambda: normal(3, 5), ELEMENTWISE),
    ("TanhShrink", "TanhShrink", (), lambda: normal(3, 5), ELEMENTWISE),
    ("LogSigmoid", "LogSigmoid", (), lambda: normal(3, 5), ELEMENTWISE),
    ("SoftMax", "SoftMax", (), lambda: normal(3, 5), ELEMENTWISE),
    ("SoftMin", "SoftMin", (), lambda: normal(3, 5), ELEMENTWISE),
    ("SoftPlus", "SoftPlus", (2.0,), lambda: normal(3, 5), ELEMENTWISE),
    ("SoftSign", "SoftSign", (), lambda: normal(3, 5), ELEMENTWISE),
    ("SoftShrink", "SoftShrink", (0.3,), lambda: normal(3, 5), ELEMENTWISE),
    ("HardShrink", "HardShrink", (0.3,), lambda: normal(3, 5), ELEMENTWISE),
    ("HardTanh", "HardTanh", (-0.5, 0.8), lambda: normal(3, 5), ELEMENTWISE),
    ("Clamp", "Clamp", (-0.2, 0.4), lambda: normal(3, 5), ELEMENTWISE),
    ("LookupTable-maxnorm-p1", "LookupTable", (10, 4, 0, 0.8, 1.0),
     lambda: ids(3, 5, n=10), ELEMENTWISE),
    ("LookupTable-maxnorm-p2", "LookupTable", (10, 4, 0, 0.8, 2.0),
     lambda: ids(3, 5, n=10), ELEMENTWISE),
    ("LookupTable-maxnorm-p3", "LookupTable", (10, 4, 0, 0.8, 3.0),
     lambda: ids(3, 5, n=10), ELEMENTWISE),
    ("Power", "Power", (2.5, 0.5, 1.0), lambda: positive(3, 5),
     ELEMENTWISE),
    ("Sqrt", "Sqrt", (), lambda: positive(3, 5), ELEMENTWISE),
    ("Square", "Square", (), lambda: normal(3, 5), ELEMENTWISE),
    ("Abs", "Abs", (), lambda: normal(3, 5), ELEMENTWISE),
    ("Log", "Log", (), lambda: positive(3, 5), ELEMENTWISE),
    ("Exp", "Exp", (), lambda: normal(3, 5), ELEMENTWISE),
    ("Negative", "Negative", (), lambda: normal(3, 5), ELEMENTWISE),
    ("PReLU-shared", "PReLU", (), lambda: normal(3, 5), ELEMENTWISE),
    ("PReLU-channels", "PReLU", (3,), lambda: normal(2, 3, 4, 4),
     ELEMENTWISE),
    ("L1Penalty", "L1Penalty", (0.1, True), lambda: normal(3, 5),
     ELEMENTWISE),
    # tables
    ("ParallelTable", "ParallelTable", (),
     lambda: [ints(2, 3), ints(2, 4, seed=1)], EXACT),
    ("MapTable", "MapTable", (),
     lambda: [ints(2, 3), ints(5, 3, seed=1)], EXACT),
    ("JoinTable", "JoinTable", (2,),
     lambda: [ints(2, 3), ints(2, 4, seed=1)], EXACT),
    ("JoinTable-batch", "JoinTable", (1, 1),
     lambda: [ints(2, 3), ints(2, 4, seed=1)], EXACT),
    ("SplitTable", "SplitTable", (2,), lambda: ints(2, 3, 4), EXACT),
    ("SplitTable-neg", "SplitTable", (-1,), lambda: ints(2, 3, 4), EXACT),
    ("SelectTable", "SelectTable", (2,),
     lambda: [ints(2, 3), ints(2, 4, seed=1), ints(1, seed=2)], EXACT),
    ("SelectTable-neg", "SelectTable", (-1,),
     lambda: [ints(2, 3), ints(2, 4, seed=1)], EXACT),
    ("NarrowTable", "NarrowTable", (2, 2),
     lambda: [ints(2), ints(3, seed=1), ints(4, seed=2), ints(5, seed=3)],
     EXACT),
    ("NarrowTable-neg", "NarrowTable", (2, -1),
     lambda: [ints(2), ints(3, seed=1), ints(4, seed=2), ints(5, seed=3)],
     EXACT),
    ("FlattenTable", "FlattenTable", (),
     lambda: [ints(2), [ints(3, seed=1), [ints(4, seed=2)]],
              ints(1, seed=3)], EXACT),
    ("MixtureTable-table", "MixtureTable", (),
     lambda: [ints(2, 3), [ints(2, 4, seed=i + 1) for i in range(3)]],
     EXACT),
    ("MixtureTable-tensor", "MixtureTable", (),
     lambda: [ints(2, 3), ints(2, 3, 4, seed=1)], EXACT),
    ("CSubTable", "CSubTable", (),
     lambda: [ints(2, 3), ints(2, 3, seed=1)], EXACT),
    ("CMulTable", "CMulTable", (),
     lambda: [ints(2, 3), ints(2, 3, seed=1), ints(2, 3, seed=2)], EXACT),
    ("CDivTable", "CDivTable", (),
     lambda: [ints(2, 3), ints(2, 3, lo=1, seed=1)], EXACT),
    ("CMaxTable", "CMaxTable", (),
     lambda: [normal(2, 3), normal(2, 3, seed=1), normal(2, 3, seed=2)],
     EXACT),
    ("CMinTable", "CMinTable", (),
     lambda: [normal(2, 3), normal(2, 3, seed=1)], EXACT),
    ("PairwiseDistance-1", "PairwiseDistance", (1,),
     lambda: [ints(3, 4), ints(3, 4, seed=1)], EXACT),
    ("PairwiseDistance-2", "PairwiseDistance", (2,),
     lambda: [ints(3, 4), ints(3, 4, seed=1)], ELEMENTWISE),
    ("CosineDistance", "CosineDistance", (),
     lambda: [normal(3, 4), normal(3, 4, seed=1)], ELEMENTWISE),
    # structural
    ("Echo", "Echo", (), lambda: ints(2, 3), EXACT),
    ("Contiguous", "Contiguous", (), lambda: ints(2, 3), EXACT),
    ("InferReshape", "InferReshape", ((0, -1, 2),),
     lambda: ints(3, 4, 2), EXACT),
    ("InferReshape-batch", "InferReshape", ((-1, 0), True),
     lambda: ints(2, 3, 4), EXACT),
    ("Squeeze-all", "Squeeze", (), lambda: ints(2, 1, 3, 1), EXACT),
    ("Squeeze-dim", "Squeeze", (2,), lambda: ints(2, 1, 3, 1), EXACT),
    ("Squeeze-batch", "Squeeze", (1, 2), lambda: ints(2, 1, 3), EXACT),
    ("Unsqueeze", "Unsqueeze", (2,), lambda: ints(2, 3), EXACT),
    ("Unsqueeze-batch", "Unsqueeze", (1, 1), lambda: ints(2, 3), EXACT),
    ("Narrow", "Narrow", (2, 2, 3), lambda: ints(2, 6), EXACT),
    ("Narrow-neg", "Narrow", (-1, 2, -2), lambda: ints(2, 6), EXACT),
    ("Index", "Index", (2,),
     lambda: [ints(3, 5), np.array([3, 1, 5, 2], np.float32)], EXACT),
    ("MaskedSelect", "MaskedSelect", (),
     lambda: [ints(3, 4), ints(3, 4, lo=0, hi=2, seed=1)], EXACT),
    ("Max", "Max", (2,), lambda: normal(3, 4), EXACT),
    ("Max-batch", "Max", (1, 1), lambda: normal(3, 4), EXACT),
    ("Min", "Min", (-1,), lambda: normal(3, 4), EXACT),
    ("Mean", "Mean", (2, -1, False), lambda: ints(3, 4), EXACT),
    ("Sum", "Sum", (1,), lambda: ints(3, 4), EXACT),
    ("Sum-average", "Sum", (1, 1, True), lambda: ints(3, 4), EXACT),
    ("Replicate", "Replicate", (3, 2), lambda: ints(2, 4), EXACT),
    ("Replicate-batch", "Replicate", (3, 1, 1), lambda: ints(2, 4), EXACT),
    ("Padding-after", "Padding", (2, 2, 2, 1.5), lambda: ints(2, 3, 4),
     EXACT),
    ("Padding-before", "Padding", (1, -3, 1), lambda: ints(2, 3), EXACT),
    ("SpatialZeroPadding", "SpatialZeroPadding", (1, 2, 0, 1),
     lambda: ints(2, 3, 4, 5), EXACT),
    ("SpatialZeroPadding-crop", "SpatialZeroPadding", (-1, 2, -2, 1),
     lambda: ints(2, 3, 4, 5), EXACT),
    ("GradientReversal", "GradientReversal", (0.5,), lambda: ints(2, 3),
     EXACT),
    ("Scale", "Scale", ((3, 1, 1),), lambda: ints(2, 3, 4, 4), EXACT),
    ("MM", "MM", (), lambda: [ints(2, 3, 4), ints(2, 4, 5, seed=1)], EXACT),
    ("MM-trans", "MM", (True, True),
     lambda: [ints(4, 3), ints(5, 4, seed=1)], EXACT),
    ("MV", "MV", (), lambda: [ints(2, 3, 4), ints(2, 4, seed=1)], EXACT),
    ("MV-trans", "MV", (True,), lambda: [ints(4, 3), ints(4, seed=1)],
     EXACT),
    ("DotProduct", "DotProduct", (),
     lambda: [ints(3, 4), ints(3, 4, seed=1)], EXACT),
    ("Pack", "Pack", (2,),
     lambda: [ints(2, 3), ints(2, 3, seed=1), ints(2, 3, seed=2)], EXACT),
    ("Reverse", "Reverse", (2,), lambda: ints(2, 3, 4), EXACT),
    ("AddConstant", "AddConstant", (2.5,), lambda: ints(2, 3), EXACT),
    # the linear family
    ("Bilinear", "Bilinear", (3, 4, 5), lambda: [normal(2, 3),
                                                  normal(2, 4, seed=1)],
     ELEMENTWISE),
    ("Add", "Add", (5,), lambda: normal(3, 5), ELEMENTWISE),
    ("Mul", "Mul", (), lambda: normal(3, 5), ELEMENTWISE),
    ("CMul", "CMul", ((1, 5),), lambda: normal(3, 5), ELEMENTWISE),
    ("CAdd", "CAdd", ((3, 1),), lambda: normal(3, 5), ELEMENTWISE),
    ("Euclidean", "Euclidean", (5, 4), lambda: normal(3, 5), ELEMENTWISE),
    ("Cosine", "Cosine", (5, 4), lambda: normal(3, 5), ELEMENTWISE),
]

#: children of the table containers, built in both packages
CHILDREN = {"ParallelTable": lambda nn: [nn.Linear(3, 2), nn.Linear(4, 2)],
            "MapTable": lambda nn: [nn.Linear(3, 2)]}


def build(nn, name, args):
    m = getattr(nn, name)(*args)
    for child in CHILDREN.get(name, lambda _: [])(nn):
        m.add(child)
    return m


def jax_apply(jm, params, x, gy, training=True):
    """The JAX module's output and the VJP of ``gy`` (parameters, input)."""
    state = jm._init_state()

    def f(p, xs):
        return jm.apply(p, xs, state, training=training)[0]

    out, vjp = jax.vjp(f, params, jax.tree_util.tree_map(jnp.asarray, x))
    pg, xg = vjp(jax.tree_util.tree_map(jnp.asarray, gy))
    return out, pg, xg


def port_apply(pm, x, gy):
    """The port's output and the gradients of ``gy`` (input, parameters
    in the JAX layout)."""
    xt = to_torch(x)
    out = pm(xt)
    outs = [o for o in leaves(out) if o.requires_grad]
    ins = [t for t in leaves(xt) if t.requires_grad]
    params = list(pm.parameters())
    gys = [torch.from_numpy(np.array(g)) for o, g in zip(leaves(out),
                                                        leaves(gy))
           if o.requires_grad]
    grads = torch.autograd.grad(outs, ins + params, gys,
                                allow_unused=True) if outs else \
        [None] * (len(ins) + len(params))
    for p, g in zip(params, grads[len(ins):]):
        p.grad = torch.zeros_like(p) if g is None else g
    from bigdl_tpu_torch.utils.convert import grads_to_jax
    return out, grads[:len(ins)], grads_to_jax(pm)


@pytest.mark.parametrize("case", MODULE_CASES, ids=[c[0] for c in MODULE_CASES])
def test_module_matches_jax(case):
    cid, name, args, make, kind = case
    jm, pm = build(jnn, name, args), build(pnn, name, args)
    x = make()
    params = (exact_params if kind == EXACT else jax_params)(jm, 0)
    params_from_jax(params, pm)
    shapes = jax.eval_shape(
        lambda p, xs: jm.apply(p, xs, jm._init_state(), training=True)[0],
        params, jax.tree_util.tree_map(jnp.asarray, x))
    rng = np.random.default_rng(7)
    gy = jax.tree_util.tree_map(
        lambda o: (rng.integers(-3, 4, o.shape) if kind == EXACT
                   else rng.standard_normal(o.shape)).astype(np.float32),
        shapes)
    out_j, pg_j, xg_j = jax_apply(jm, params, x, gy)
    out_p, xg_p, pg_p = port_apply(pm, x, gy)
    for a, b in zip(leaves(out_p), jax.tree_util.tree_leaves(out_j),
                    strict=True):
        check(a.detach().numpy(), b, kind, f"{cid} output")
    xg_j = [g for g, xi in zip(jax.tree_util.tree_leaves(xg_j), leaves(x))
            if np.asarray(xi).dtype.kind == "f"]
    for a, b in zip(xg_p, xg_j, strict=True):
        a = np.zeros(b.shape, np.float32) if a is None else a.numpy()
        check(a, b, kind, f"{cid} input gradient")
    for a, b in zip(jax.tree_util.tree_leaves(pg_p),
                    jax.tree_util.tree_leaves(pg_j), strict=True):
        check(a, b, kind, f"{cid} parameter gradient")


def _nll_target(n, c, seed=3):
    return np.random.default_rng(seed).integers(1, c + 1, n).astype(
        np.float32)


def _signs(n, seed=3):
    return np.where(np.random.default_rng(seed).random(n) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _simple(name, *args):
    return lambda nn: getattr(nn, name)(*args)


def _multi(nn):
    return nn.MultiCriterion().add(nn.MSECriterion(), 0.5).add(
        nn.AbsCriterion(), 2.0)


def _parallel(nn):
    return nn.ParallelCriterion().add(nn.MSECriterion(), 0.5).add(
        nn.ClassNLLCriterion(), 1.5)


# (case id, criterion maker, input maker, target maker)
CRITERION_CASES = [
    ("AbsCriterion", _simple("AbsCriterion"), lambda: normal(3, 4),
     lambda: normal(3, 4, seed=1)),
    ("BCECriterion", _simple("BCECriterion", [0.5, 1.0, 2.0, 1.0]),
     lambda: np.random.default_rng(0).uniform(0.05, 0.95, (3, 4))
     .astype(np.float32),
     lambda: ints(3, 4, lo=0, hi=2, seed=1)),
    ("DistKLDivCriterion", _simple("DistKLDivCriterion"),
     lambda: np.log(positive(3, 4) / 4),
     lambda: np.where(ints(3, 4, lo=0, hi=3, seed=1) > 0,
                      positive(3, 4, seed=2) / 4, 0).astype(np.float32)),
    ("CosineEmbeddingCriterion", _simple("CosineEmbeddingCriterion", 0.1),
     lambda: [normal(4, 5), normal(4, 5, seed=1)], lambda: _signs(4)),
    ("HingeEmbeddingCriterion", _simple("HingeEmbeddingCriterion", 0.5),
     lambda: normal(6), lambda: _signs(6)),
    ("L1HingeEmbeddingCriterion", _simple("L1HingeEmbeddingCriterion", 9.0),
     lambda: [normal(5), normal(5, seed=1)],
     lambda: np.array([-1.0], np.float32)),
    ("MarginCriterion", _simple("MarginCriterion", 0.7),
     lambda: normal(6), lambda: _signs(6)),
    ("MarginRankingCriterion", _simple("MarginRankingCriterion", 0.3),
     lambda: [normal(6), normal(6, seed=1)], lambda: _signs(6)),
    ("MultiCriterion", _multi, lambda: normal(3, 4),
     lambda: normal(3, 4, seed=1)),
    ("ParallelCriterion", _parallel,
     lambda: [normal(3, 4), np.log(positive(3, 5) / 5)],
     lambda: [normal(3, 4, seed=1), _nll_target(3, 5)]),
    ("MultiLabelMarginCriterion", _simple("MultiLabelMarginCriterion"),
     lambda: normal(3, 5),
     lambda: np.array([[2, 4, 0, 0, 0], [5, 0, 0, 0, 0], [2, 3, 5, 0, 0]],
                      np.float32)),
    ("MultiLabelSoftMarginCriterion",
     _simple("MultiLabelSoftMarginCriterion", [1.0, 0.5, 2.0, 1.0]),
     lambda: normal(3, 4), lambda: ints(3, 4, lo=0, hi=2, seed=1)),
    ("MultiMarginCriterion-p1", _simple("MultiMarginCriterion"),
     lambda: normal(4, 5), lambda: _nll_target(4, 5)),
    ("MultiMarginCriterion-p2", _simple("MultiMarginCriterion", 2,
                                        [1.0, 2.0, 0.5, 1.0, 1.5], 0.8),
     lambda: normal(4, 5), lambda: _nll_target(4, 5)),
    ("SmoothL1Criterion", _simple("SmoothL1Criterion"),
     lambda: normal(3, 4, scale=2), lambda: normal(3, 4, seed=1)),
    ("SmoothL1CriterionWithWeights",
     _simple("SmoothL1CriterionWithWeights", 2.0, 4),
     lambda: normal(3, 4, scale=2),
     lambda: [normal(3, 4, seed=1), positive(3, 4, seed=2),
              positive(3, 4, seed=3)]),
    ("SoftmaxWithCriterion", _simple("SoftmaxWithCriterion"),
     lambda: normal(2, 4, 3, 3),
     lambda: _nll_target(18, 4).reshape(2, 3, 3)),
    ("SoftmaxWithCriterion-ignore", _simple("SoftmaxWithCriterion", 2,
                                            "FULL"),
     lambda: normal(2, 4, 3, 3),
     lambda: _nll_target(18, 4).reshape(2, 1, 3, 3)),
    ("SoftMarginCriterion", _simple("SoftMarginCriterion"),
     lambda: normal(6), lambda: _signs(6)),
    ("L1Cost", _simple("L1Cost"), lambda: normal(3, 4), lambda: None),
    ("CosineDistanceCriterion", _simple("CosineDistanceCriterion"),
     lambda: normal(3, 4), lambda: normal(3, 4, seed=1)),
    ("DiceCoefficientCriterion", _simple("DiceCoefficientCriterion",
                                         True, 0.5),
     lambda: positive(3, 4) / 2, lambda: ints(3, 4, lo=0, hi=2, seed=1)),
    ("ClassSimplexCriterion", _simple("ClassSimplexCriterion", 5),
     lambda: normal(4, 5, scale=0.5), lambda: _nll_target(4, 5)),
]


@pytest.mark.parametrize("case", CRITERION_CASES,
                         ids=[c[0] for c in CRITERION_CASES])
def test_criterion_matches_jax(case):
    cid, make_crit, make_x, make_t = case
    jc, pc = make_crit(jnn), make_crit(pnn)
    x, t = make_x(), make_t()
    jx = jax.tree_util.tree_map(jnp.asarray, x)
    jt = None if t is None else jax.tree_util.tree_map(jnp.asarray, t)
    loss_j, vjp = jax.vjp(lambda v: jc.apply(v, jt), jx)
    (grad_j,) = vjp(jnp.ones_like(loss_j))
    px = to_torch(x, grad=False)
    pt = None if t is None else to_torch(t, grad=False)
    loss_p = pc.forward(px, pt)
    grad_p = pc.backward(px, pt)
    check(loss_p.detach().numpy(), loss_j, CRITERION, f"{cid} loss")
    for a, b in zip(leaves(grad_p), jax.tree_util.tree_leaves(grad_j),
                    strict=True):
        check(a.numpy(), b, CRITERION, f"{cid} gradient")


def test_time_distributed_separable_criterions():
    """The separable path now also takes ``AbsCriterion`` and an unweighted
    ``BCECriterion``, as the JAX package's does."""
    x = np.random.default_rng(0).uniform(0.1, 0.9, (2, 3, 4)) \
        .astype(np.float32)
    t = ints(2, 3, 4, lo=0, hi=2, seed=1)
    for name in ("AbsCriterion", "BCECriterion"):
        jc = jnn.TimeDistributedCriterion(getattr(jnn, name)(), True)
        pc = pnn.TimeDistributedCriterion(getattr(pnn, name)(), True)
        assert pc._separable()
        check(pc.forward(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
              jc.forward(jnp.asarray(x), jnp.asarray(t)), CRITERION, name)


# ---- stochastic layers ------------------------------------------------------

STOCHASTIC = [("RReLU", (0.1, 0.4)), ("GaussianDropout", (0.3,)),
              ("GaussianNoise", (0.5,)), ("Dropout", (0.4,))]


@pytest.mark.parametrize("name,args", STOCHASTIC,
                         ids=[s[0] for s in STOCHASTIC])
def test_stochastic_eval_mode_is_exact(name, args):
    x = normal(4, 6)
    jm, pm = getattr(jnn, name)(*args), getattr(pnn, name)(*args)
    out_j, _, xg_j = jax_apply(jm, {}, x, np.ones_like(x), training=False)
    pm.evaluate()
    g = torch.Generator().manual_seed(0)
    with random_stream(pm, g):
        xt = to_torch(x)
        out = pm(xt)
        (xg,) = torch.autograd.grad(out, xt, torch.ones_like(out))
    np.testing.assert_array_equal(out.detach().numpy(), out_j)
    np.testing.assert_array_equal(xg.numpy(), xg_j)


@pytest.mark.parametrize("name,args", STOCHASTIC,
                         ids=[s[0] for s in STOCHASTIC])
def test_stochastic_training_moments_and_replay(name, args):
    """The noise of one training-mode forward over 200000 entries has its
    mean and variance within 1% (relative, or 3e-3 absolute for a mean of
    0), and the shell's backward uses the forward's draw: the input's
    gradient is what the drawn noise gives."""
    n = 200_000
    x = torch.full((n,), -2.0) if name == "RReLU" else torch.ones(n)
    pm = getattr(pnn, name)(*args)
    out = pm.update_output(x)
    if name == "RReLU":
        noise, mean, var = out / x, 0.25, 0.3 ** 2 / 12
    elif name == "GaussianDropout":
        noise, mean, var = out / x, 1.0, 0.3 / 0.7
    elif name == "GaussianNoise":
        noise, mean, var = out - x, 0.0, 0.25
    else:
        noise, mean, var = out / x, 1.0, 0.4 / 0.6
    assert abs(noise.mean().item() - mean) <= max(0.01 * mean, 3e-3)
    assert abs(noise.var().item() - var) <= 0.01 * var
    if name == "RReLU":
        assert noise.min() >= 0.1 and noise.max() <= 0.4
    g = torch.randn(n, generator=torch.Generator().manual_seed(1))
    gin = pm.backward(x, g)
    expect = g if name == "GaussianNoise" else g * noise
    torch.testing.assert_close(gin, expect, rtol=1e-6, atol=0)
    # a second forward draws anew
    assert not torch.equal(pm.update_output(x), out)


# ---- initialisers -----------------------------------------------------------

def test_initialisers():
    shape = (3, 4, 5, 5)
    np.testing.assert_array_equal(pnn.Ones()(shape).numpy(),
                                  jnn.Ones()(None, shape))
    np.testing.assert_array_equal(pnn.ConstInitMethod(0.3)(shape).numpy(),
                                  jnn.ConstInitMethod(0.3)(None, shape))
    # the port's (out, in, kh, kw) layout of the JAX package's HWIO
    for k in ((4, 4), (3, 5)):
        p = pnn.BilinearFiller()((2, 3) + k).numpy()
        j = np.asarray(jnn.BilinearFiller()(None, k + (3, 2)))
        np.testing.assert_array_equal(p, np.transpose(j, (3, 2, 0, 1)))
    g = torch.Generator().manual_seed(0)
    for fan_in, fan_out, var_fan_in in ((100, 50, True), (100, 50, False)):
        w = pnn.MsraFiller(var_fan_in)((400, 500), fan_in, fan_out,
                                       generator=g)
        std = (2.0 / (fan_in if var_fan_in else fan_out)) ** 0.5
        assert abs(w.std().item() - std) <= 0.01 * std
        assert abs(w.mean().item()) <= 0.01 * std


# ---- the imperative shell ---------------------------------------------------

def _shell_models():
    def mlp(nn):
        return (nn.Sequential().add(nn.Linear(6, 8)).add(nn.PReLU(8))
                .add(nn.BatchNormalization(8)).add(nn.Dropout(0.0))
                .add(nn.Linear(8, 4)).add(nn.LogSoftMax()))
    jm, pm = mlp(jnn), mlp(pnn)
    params = jax_params(jm, 0)
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = jm._init_state()
    jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    jm._adopt()
    params_from_jax(params, pm)
    return jm, pm


def test_shell_trains_like_the_jax_shell():
    jm, pm = _shell_models()
    jc, pc = jnn.ClassNLLCriterion(), pnn.ClassNLLCriterion()
    lr = 0.1
    for step in range(3):
        x = normal(5, 6, seed=step)
        y = _nll_target(5, 4, seed=step)
        for m, c, xs, ys in ((jm, jc, jnp.asarray(x), jnp.asarray(y)),
                             (pm, pc, torch.from_numpy(x),
                              torch.from_numpy(y))):
            m.zero_grad_parameters()
            out = m.update_output(xs) if m is pm else m.forward(xs)
            c.forward(out, ys)
            m.backward(xs, c.backward(out, ys))
            m.update_parameters(lr)
    wj, gj = jm.get_parameters()
    wp, gp = pm.get_parameters()
    assert wp.shape == (pm.n_parameters(),) == (jm.n_parameters(),)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(state_to_jax(pm)),
                    jax.tree_util.tree_leaves(jm.state), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)


def test_get_parameters_is_the_jax_flat_order():
    """Same weights in both packages give the same flat vector, entry for
    entry (a layer's entries by sorted name, ``Linear`` (in, out));
    ``set_flat_parameters`` is its inverse."""
    jm, pm = _shell_models()
    wj, _ = jm.get_parameters()
    wp, gp = pm.get_parameters()
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    assert not gp.any()
    pm.set_flat_parameters(2 * wp)
    np.testing.assert_array_equal(pm.get_parameters()[0].numpy(),
                                  2 * np.asarray(wj))
    tree = params_to_jax(pm)
    np.testing.assert_array_equal(tree[0]["weight"],
                                  2 * np.asarray(jm.params[0]["weight"]))


def test_update_grad_input_and_acc_grad_parameters():
    jm, pm = _shell_models()
    x, y = normal(5, 6), _nll_target(5, 4)
    pm.zero_grad_parameters()
    jm.zero_grad_parameters()
    out = pm.update_output(torch.from_numpy(x))
    jout = jm.forward(jnp.asarray(x))
    g = pnn.ClassNLLCriterion().backward(out, torch.from_numpy(y))
    jg = jnn.ClassNLLCriterion().backward(jout, jnp.asarray(y))
    stats = [b.clone() for b in pm.buffers()]
    gin = pm.update_grad_input(torch.from_numpy(x), g)
    np.testing.assert_allclose(gin.numpy(), np.asarray(
        jm.update_grad_input(jnp.asarray(x), jg)), rtol=0, atol=1e-6)
    assert not pm.get_parameters()[1].any()
    for b, kept in zip(pm.buffers(), stats):   # no second statistics update
        assert torch.equal(b, kept)
    pm.acc_grad_parameters(torch.from_numpy(x), g)
    once = pm.get_parameters()[1].clone()
    jm.acc_grad_parameters(jnp.asarray(x), jg)
    np.testing.assert_allclose(once.numpy(), np.asarray(jm.get_parameters()[1]),
                               rtol=0, atol=1e-6)
    pm.acc_grad_parameters(torch.from_numpy(x), g)
    torch.testing.assert_close(pm.get_parameters()[1], 2 * once, rtol=0,
                               atol=0)


def test_scale_w_and_scale_b():
    jl, pl = jnn.Linear(4, 3), pnn.Linear(4, 3)
    params = jax_params(jl, 0)
    params_from_jax(params, pl)
    jl._params = jax.tree_util.tree_map(jnp.asarray, params)
    jl._state, jl._grads = {}, jax.tree_util.tree_map(jnp.zeros_like,
                                                      jl._params)
    x, g = normal(2, 4), normal(2, 3, seed=1)
    pl.zero_grad_parameters()
    pl.backward(torch.from_numpy(x), torch.from_numpy(g))
    plain = pl.get_parameters()[1].clone()
    for m in (jl, pl):
        m.scale_w, m.scale_b = 2.0, 3.0
        m.zero_grad_parameters()
    jl.backward(jnp.asarray(x), jnp.asarray(g))
    pl.backward(torch.from_numpy(x), torch.from_numpy(g))
    scaled = pl.get_parameters()[1]
    np.testing.assert_allclose(scaled.numpy(),
                               np.asarray(jl.get_parameters()[1]),
                               rtol=1e-6, atol=1e-7)
    # flat order: bias (3) then weight (12)
    torch.testing.assert_close(scaled[:3], 3 * plain[:3], rtol=0, atol=0)
    torch.testing.assert_close(scaled[3:], 2 * plain[3:], rtol=0, atol=0)


def test_shell_bookkeeping():
    _, pm = _shell_models()
    x = torch.from_numpy(normal(5, 6))
    out = pm.update_output(x)
    assert pm.output is out
    pm.backward(x, torch.ones_like(out))
    times = pm.get_times()
    assert times[0][0] is pm and times[0][1] > 0 and times[0][2] > 0
    pm.reset_times()
    assert all(f == 0 and b == 0 for _, f, b in pm.get_times())
    clone = pm.clone_module()
    torch.testing.assert_close(clone.get_parameters()[0],
                               pm.get_parameters()[0], rtol=0, atol=0)
    assert clone.layers[0].weight is not pm.layers[0].weight
    table = pm.get_parameters_table()
    assert sorted(table) == ["layers.0", "layers.1", "layers.2", "layers.4"]
    params, grads = pm.params_and_grads()
    assert len(params) == len(grads) == len(list(pm.parameters()))


# ---- Graph -------------------------------------------------------------------

def _dag(nn):
    in1, in2 = nn.Input(), nn.Input()
    a = nn.Linear(4, 6).inputs(in1)
    b = nn.Linear(3, 6).inputs(in2)
    joined = nn.CAddTable().inputs(a, b)
    left = nn.Tanh().inputs(joined)          # the split: two successors
    right = nn.Sigmoid().inputs(joined)
    cat = nn.JoinTable(2).inputs(left, right)
    head = nn.Linear(12, 2).inputs(cat)
    return nn.Graph([in1, in2], [head, right])


def test_graph_matches_jax():
    jg, pg = _dag(jnn), _dag(pnn)
    assert [type(m).__name__ for m in pg.layers] == \
        [type(m).__name__ for m in jg.children]
    params = jax_params(jg, 0)
    params_from_jax(params, pg)
    x = [normal(3, 4), normal(3, 3, seed=1)]
    gy = [normal(3, 2, seed=2), normal(3, 6, seed=3)]
    out_j, pg_j, xg_j = jax_apply(jg, params, x, gy)
    out_p, xg_p, pg_p = port_apply(pg, x, gy)
    for a, b in zip(leaves(out_p) + list(xg_p), jax.tree_util.tree_leaves(out_j)
                    + jax.tree_util.tree_leaves(xg_j), strict=True):
        check(a.detach().numpy(), b, GRAPH, "graph output / input")
    for a, b in zip(jax.tree_util.tree_leaves(pg_p),
                    jax.tree_util.tree_leaves(pg_j), strict=True):
        check(a, b, GRAPH, "graph parameter gradient")
    # the shell through the graph: the same gradients
    pg.zero_grad_parameters()
    gin = pg.backward([torch.from_numpy(v) for v in x],
                      [torch.from_numpy(v) for v in gy])
    for a, b in zip(gin, xg_p, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_graph_cycle_raises():
    for nn in (jnn, pnn):
        n1 = nn.Identity().inputs()
        n2 = nn.Identity().inputs(n1)
        n1.inputs(n2)
        with pytest.raises(ValueError, match="cycle"):
            nn.Graph([n1], [n2])
