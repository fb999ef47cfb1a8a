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
from bigdl_tpu_torch.utils.convert import params_from_jax

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


# (case id, class name, constructor args, input maker, tolerance), by
# family; each family is one file's cases of test_module_matches_jax
ACTIVATION_CASES = [
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
]

TABLE_CASES = [
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
]

#: reshaping and selection
SHAPE_CASES = [
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
]

#: reductions, padding and products
REDUCTION_CASES = [
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
]

#: the linear family and L1Penalty
LINEAR_CASES = [
    ("Bilinear", "Bilinear", (3, 4, 5), lambda: [normal(2, 3),
                                                  normal(2, 4, seed=1)],
     ELEMENTWISE),
    ("Add", "Add", (5,), lambda: normal(3, 5), ELEMENTWISE),
    ("Mul", "Mul", (), lambda: normal(3, 5), ELEMENTWISE),
    ("CMul", "CMul", ((1, 5),), lambda: normal(3, 5), ELEMENTWISE),
    ("CAdd", "CAdd", ((3, 1),), lambda: normal(3, 5), ELEMENTWISE),
    ("Euclidean", "Euclidean", (5, 4), lambda: normal(3, 5), ELEMENTWISE),
    ("Cosine", "Cosine", (5, 4), lambda: normal(3, 5), ELEMENTWISE),
    ("L1Penalty", "L1Penalty", (0.1, True), lambda: normal(3, 5),
     ELEMENTWISE),
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


def check_module_case(case):
    """One case of a ``*_CASES`` list: forward output, input gradient and
    parameter gradients of the class in both packages agree."""
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


@pytest.mark.parametrize("case", ACTIVATION_CASES,
                         ids=[c[0] for c in ACTIVATION_CASES])
def test_module_matches_jax(case):
    check_module_case(case)


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


# ---- stochastic layers ------------------------------------------------------

STOCHASTIC = [("RReLU", (0.1, 0.4)), ("GaussianDropout", (0.3,)),
              ("GaussianNoise", (0.5,)), ("Dropout", (0.4,))]


# ---- initialisers -----------------------------------------------------------

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
