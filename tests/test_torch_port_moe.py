"""The port's sharded-transformer layers held against the JAX package on the
CPU, in one process: ``MixtureOfExperts`` (the twins of
``tests/test_moe.py``'s single-device cases), ``chunked_attention``,
``Remat`` under each policy, the MoE ``transformer_lm`` (forward, gradient
and three ``LocalOptimizer`` steps with the aux penalty), the tensor-parallel
spec walk, and every refusal the JAX package makes (the ranks run in
``tests/test_torch_port_model_parallel.py``).

Inputs come from numpy seeds; the JAX parameters are carried into the port
with ``params_from_jax``.  Tolerances (fp32 throughout, the same sums in
other orders):
- MoE outputs, combine weights and the aux scalar: atol 1e-5, rtol 1e-5;
  gradients: atol 2e-5, rtol 1e-4; routing (dispatch, slots, keep):
  exact;
- grouped against einsum, in the port: atol 1e-6, rtol 1e-5 (the JAX
  test's);
- chunked attention: outputs atol 1e-5, gradients atol 2e-5;
- the MoE LM's log-probs: atol 1e-4 (``tests/test_torch_port_lm.py``'s
  fp32 tolerance), its gradients atol 2e-5, three trained SGD steps'
  weights atol 1e-5 (``tests/test_torch_port_training.py``'s);
- ``Remat`` against the unwrapped port model: bit-identical forward and
  atol 1e-7 gradients (the recompute runs the same ops; the selective
  policies save some of them).
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.transformer import transformer_lm as jax_lm
from bigdl_tpu.nn.attention import chunked_attention as jax_chunked
from bigdl_tpu.nn.module import semantic_state_leaves as jax_semantic
from bigdl_tpu.nn.moe import MixtureOfExperts as JaxMoE
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.models.transformer import transformer_lm
from bigdl_tpu_torch.nn import MixtureOfExperts, MultiHeadAttention
from bigdl_tpu_torch.nn.attention import chunked_attention
from bigdl_tpu_torch.nn.module import (collect_diagnostics,
                                       semantic_state_leaves)
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_to_jax)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

D, E = 8, 4
ATOL, RTOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
LM = dict(d_model=32, n_head=2, n_layers=2, max_len=16)
LM1 = dict(LM, n_layers=1)      # a JAX Remat's compile doubles a layer's
VOCAB = 32


@contextlib.contextmanager
def impl(name):
    """``bigdl.moe.impl`` set in both packages for the block."""
    for mod in (jconfig, pconfig):
        mod.set_property("bigdl.moe.impl", name)
    try:
        yield
    finally:
        for mod in (jconfig, pconfig):
            mod.clear_property("bigdl.moe.impl")


@contextlib.contextmanager
def seeded(seed):
    saved = [getattr(cls._tls, "inst", None)
             for cls in (JaxRandomGenerator, RandomGenerator)]
    JaxRandomGenerator._tls.inst = JaxRandomGenerator(seed)
    RandomGenerator._tls.inst = RandomGenerator(seed)
    try:
        yield
    finally:
        for cls, inst in zip((JaxRandomGenerator, RandomGenerator), saved):
            if inst is None:
                del cls._tls.inst
            else:
                cls._tls.inst = inst


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _expert(pkg):
    kw = {} if pkg is jnn else {"device": "cpu"}
    return (pkg.Sequential().add(pkg.Linear(D, 2 * D, **kw)).add(pkg.ReLU())
            .add(pkg.Linear(2 * D, D, **kw)))


def _install(jm, seed):
    """The JAX model's parameters drawn with numpy (shapes from
    ``jax.eval_shape``: its own init compiles a random draw per shape) and
    installed, its state zeros: U(-a, a) of variance 1 / fan-in (the
    second-to-last dim), LayerNorm-style 1-D weights near 1."""
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        shape = sd.shape
        if len(shape) == 1:
            base = 1.0 if path[-1].key == "weight" else 0.0
            return (base + rng.uniform(-0.1, 0.1, shape)).astype(np.float32)
        half = np.float32(np.sqrt(3.0 / shape[-2]))
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * half

    params = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm._init_params, jax.random.PRNGKey(0)))
    state = jax.tree_util.tree_map(
        lambda sd: np.zeros(sd.shape, sd.dtype),
        jax.eval_shape(jm._init_state))
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    if hasattr(jm, "_adopt"):        # a container's children see theirs
        jm._adopt()
    return params


def _twins(capacity_factor=8.0, top_k=1, seed=3, capacity=None):
    jm = JaxMoE(D, _expert(jnn), E, capacity_factor=capacity_factor,
                top_k=top_k, capacity=capacity)
    params = _install(jm, seed)
    pm = MixtureOfExperts(D, _expert(pnn), E, capacity_factor=capacity_factor,
                          top_k=top_k, capacity=capacity)
    return jm, params_from_jax(params, pm)


def _x(n, seed, scale=1.0):
    return (np.random.RandomState(seed).normal(size=(n, D)) *
            scale).astype(np.float32)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------------ the layer

def _jax_moe_run(jm, path):
    """The JAX layer's forward, aux and parameter gradients of sum(y^2)
    under ``bigdl.moe.impl`` ``path``, jitted (the config is read when it
    traces)."""
    def f(p, x):
        y, state = jm.apply(p, x, jm.state)
        return jnp.sum(y ** 2), (y, state["aux_loss"])
    with impl(path):
        (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(jm.params, jnp.asarray(jm._x))
    return y, aux, grads


@pytest.mark.parametrize("top_k,cf,x_kind,path", [
    (1, 8.0, "normal", "einsum"), (1, 0.26, "ones", "grouped"),
    (2, 0.26, "normal", "einsum"), (2, 0.26, "normal", "grouped")])
def test_moe_matches_jax(top_k, cf, x_kind, path):
    """Routing tensors, the forward under each ``bigdl.moe.impl``, the aux
    scalar in the state and the gradients of every parameter, with and
    without capacity drops (cf 0.26: capacity 2 of 16 tokens; all-ones
    tokens all pick one expert)."""
    jm, pm = _twins(cf, top_k)
    x = np.ones((16, D), np.float32) if x_kind == "ones" else _x(16, 5)
    jd, jc, jaux = jax.jit(jm.route)(jm.params, jnp.asarray(x))
    pd, pc, paux = pm.route(torch.from_numpy(x))
    np.testing.assert_array_equal(pd.detach().numpy(), np.asarray(jd))
    _close(pc.detach(), jc)
    _close(paux.detach(), jaux)
    je, js, jw, jk, _ = jax.jit(jm.route_compact)(jm.params, jnp.asarray(x))
    pe, ps, pw, pk, _ = pm.route_compact(torch.from_numpy(x))
    for a, b in ((pe, je), (ps, js), (pk, jk)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(pw.detach(), jw)

    jm._x = x
    ref, aux, grads = _jax_moe_run(jm, path)
    with impl(path):
        pm.train()
        out = pm(torch.from_numpy(x))
        (out ** 2).sum().backward()
    _close(out.detach(), ref)
    _close(pm.aux_loss, aux)
    got = copy.deepcopy(pm)
    with torch.no_grad():
        for p, q in zip(got.parameters(), pm.parameters()):
            p.copy_(q.grad)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_jax(got)),
                    jax.tree_util.tree_leaves(_np(grads))):
        _close(a, b, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("check", [
    "top1_capacity_bounded", "gated_expert_output", "overflow_drops",
    "batched_shape", "bf16_bookkeeping", "top2_renormalised",
    "top2_manual_blend", "aux_floor", "capacity_scales_with_top_k",
    "explicit_capacity", "dropfree_batch_split", "grouped_equals_einsum"])
def test_moe_properties(check):
    """The port's twins of ``tests/test_moe.py``'s property checks."""
    jm, pm = _twins(0.5 if check == "top1_capacity_bounded" else 8.0,
                    2 if check.startswith("top2") else 1, seed=11)
    x = torch.from_numpy(_x(16, 1))
    if check == "top1_capacity_bounded":
        dispatch, _, _ = pm.route(x)
        assert set(dispatch.sum((1, 2)).unique().tolist()) <= {0.0, 1.0}
        assert dispatch.sum(0).max() <= 1 and \
            dispatch.shape[2] == pm.capacity(16)
    elif check == "gated_expert_output":
        out = pm(x).detach()
        gates = torch.softmax(x @ pm.gate, -1)
        for t in range(16):
            e = int(gates[t].argmax())
            one = torch.func.functional_call(
                pm.expert, {k: v[e] for k, v in
                            pm.stacked_parameters().items()}, (x[t:t + 1],))
            _close(out[t], (one[0] * gates[t, e]).detach(), 1e-5, 1e-4)
    elif check == "overflow_drops":
        pm.capacity_factor = 0.26
        out = pm(torch.ones(16, D)).detach()
        assert int((out.abs().sum(-1) < 1e-6).sum()) >= 14
    elif check == "batched_shape":
        assert pm(torch.from_numpy(
            np.random.RandomState(2).normal(size=(2, 5, D)).astype(
                np.float32))).shape == (2, 5, D)
    elif check == "bf16_bookkeeping":
        pm.to(torch.bfloat16)     # what the mixed-precision forward sees
        dispatch, _, _ = pm.route(torch.from_numpy(_x(600, 5)).bfloat16())
        assert dispatch.float().sum(0).max() <= 1.0
    elif check == "top2_renormalised":
        dispatch, combine, _ = pm.route(x)
        np.testing.assert_allclose(dispatch.sum((1, 2)).numpy(), 2.0)
        np.testing.assert_allclose(combine.sum((1, 2)).detach().numpy(),
                                   1.0, rtol=1e-5)
        gates = torch.softmax(x @ pm.gate, -1)
        chosen = dispatch.sum(2)
        for t in range(16):
            assert set(chosen[t].nonzero()[:, 0].tolist()) == \
                set(gates[t].argsort(descending=True)[:2].tolist())
    elif check == "top2_manual_blend":
        out = pm(x).detach()
        gates = torch.softmax(x @ pm.gate, -1).detach()
        for t in range(16):
            top2 = gates[t].argsort(descending=True)[:2]
            g = gates[t, top2] / gates[t, top2].sum()
            want = sum(gv * torch.func.functional_call(
                pm.expert, {k: v[e] for k, v in
                            pm.stacked_parameters().items()},
                (x[t:t + 1],))[0] for e, gv in zip(top2.tolist(), g))
            _close(out[t], want.detach(), 1e-5, 1e-4)
    elif check == "aux_floor":
        pm.train()
        pm(torch.from_numpy(_x(64, 8)))
        assert float(pm.aux_loss) >= 0.99
        assert [float(a.detach())
                for a in collect_diagnostics(pm, "aux_loss")] == \
            [float(pm.aux_loss)]
    elif check == "capacity_scales_with_top_k":
        m1, m2 = (MixtureOfExperts(D, _expert(pnn), E, 1.25, top_k=k)
                  for k in (1, 2))
        assert m2.capacity(64) == 2 * m1.capacity(64)
        dispatch, _, _ = m2.route(torch.from_numpy(_x(64, 10, 0.01)))
        assert dispatch.sum((1, 2)).mean() > 1.9
    elif check == "explicit_capacity":
        jc, pc = _twins(capacity=5, seed=7)
        assert pc.capacity(8) == pc.capacity(64) == 5 == jc.capacity(8)
        assert pc.route(torch.from_numpy(_x(16, 12)))[0].shape == (16, E, 5)
    elif check == "dropfree_batch_split":
        pm.capacity_factor = float(E)
        xs = torch.from_numpy(_x(24, 13))
        full = pm(xs).detach()
        halves = torch.cat([pm(h).detach() for h in xs.split(12)])
        _close(halves, full, 1e-6, 1e-5)
    else:
        for cf, k in ((8.0, 1), (0.26, 1), (8.0, 2), (0.26, 2)):
            pm.capacity_factor, pm.top_k = cf, k
            want = pm(x).detach()
            with impl("grouped"):
                got = pm(x).detach()
            _close(got, want, 1e-6, 1e-5)


def test_moe_state_and_refusals():
    """The state twin (``{"expert": ..., "aux_loss": ...}``), the diagnostic
    scoping of ``semantic_state_leaves``, and the JAX package's refusals:
    top_k out of range, capacity < 1, stateful experts, an unknown
    ``bigdl.moe.impl``, experts that do not split over the expert axis."""
    jm, pm = _twins()
    x = _x(16, 3)
    pm.train()
    pm(torch.from_numpy(x))
    _, state = jax.jit(jm.apply)(jm.params, jnp.asarray(x), jm.state)
    tree = state_to_jax(pm)
    assert set(tree) == {"expert", "aux_loss"}
    _close(tree["aux_loss"], state["aux_loss"])
    assert not semantic_state_leaves(pm) and not jax_semantic(jm)

    class Sneaky(pnn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("aux_loss", torch.zeros(3))
    assert semantic_state_leaves(Sneaky())
    with pytest.raises(ValueError, match="top_k"):
        MixtureOfExperts(D, pnn.Linear(D, D, device="cpu"), E, top_k=E + 1)
    with pytest.raises(ValueError, match="capacity"):
        MixtureOfExperts(D, pnn.Linear(D, D, device="cpu"), E, capacity=0)
    with pytest.raises(ValueError, match="stateless"):
        MixtureOfExperts(D, pnn.Sequential().add(
            pnn.BatchNormalization(D, device="cpu")), E)
    with impl("banana"), pytest.raises(ValueError, match="bigdl.moe.impl"):
        pm(torch.zeros(4, D))
    with pytest.raises(ValueError, match="divide"):
        MixtureOfExperts(D, pnn.Linear(D, D, device="cpu"), 6
                         ).set_expert_parallel("expert", 4)


# ------------------------------------------------------- chunked attention

@pytest.mark.parametrize("causal,tk", [(True, 48), (False, 32)])
def test_chunked_attention_matches_jax(causal, tk):
    """Forward and gradients against the JAX ``chunked_attention``, with
    the bottom-right causal mask where Tk > T."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, tk, 2, 16)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jax_chunked(q_, k_, v_, causal=causal, chunk=8)
        return jnp.sum(out * w), out
    (_, ref), jg = jax.jit(jax.value_and_grad(jloss, (0, 1, 2),
                                              has_aux=True))(
        *(jnp.asarray(a) for a in (q, k, v)))
    pt = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = chunked_attention(*pt, causal=causal, chunk=8)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach(), ref)
    for a, b in zip(pt, jg):
        _close(a.grad, b, GRAD_ATOL, GRAD_RTOL)
    with pytest.raises(ValueError, match="divisible"):
        chunked_attention(*pt, chunk=12)


# ----------------------------------------------------- the MoE LM and Remat

def _lm_twins(widths=LM, **kw):
    jm = jax_lm(VOCAB, **widths, **kw)
    params = _install(jm, 0)
    pm = transformer_lm(VOCAB, device="cpu", **widths, **kw)
    return jm, params_from_jax(params, pm)


def _ids(seed=0, n=2):
    return np.random.default_rng(seed).integers(
        1, VOCAB + 1, (n, LM["max_len"] + 1)).astype(np.float32)


def _remat_variants(wrapped, top_k):
    """The LM of ``wrapped``'s weights unwrapped, then wrapped under each
    policy (None, "nothing", "dots", "save_attn")."""
    kw = dict(device="cpu", moe_experts=E, moe_top_k=top_k, **LM1)
    plain = transformer_lm(VOCAB, **kw)
    plain.load_state_dict(_unwrap(wrapped.state_dict()))
    models = [plain, wrapped]
    for policy in ("nothing", "dots", "save_attn"):
        m = transformer_lm(VOCAB, remat=policy, **kw)
        m.load_state_dict(wrapped.state_dict())
        models.append(m)
    for m in models:
        for x in m.modules():
            if isinstance(x, MultiHeadAttention):
                x.chunk = 8
    return models


def _fwd_bwd(models, ids, w):
    outs, grads = [], []
    for m in models:
        m.train()
        out = m(torch.from_numpy(ids))
        grads.append(torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                         list(m.parameters())))
        outs.append(out.detach())
    for out, g in zip(outs[1:], grads[1:]):
        assert torch.equal(out, outs[0])
        for a, b in zip(g, grads[0]):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
    return outs, grads


def _unwrap(state):
    """A Remat-wrapped LM's state_dict keys as the unwrapped model's."""
    out = {}
    for k, v in state.items():
        parts = k.split(".")
        if len(parts) > 3 and parts[0] == "layers" and parts[2] == "layers" \
                and parts[3] == "0":
            k = ".".join(parts[:2] + parts[4:])
        out[k] = v
    return out


# ------------------------------------------------- tensor parallel specs
