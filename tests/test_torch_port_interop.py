"""Torch7 ``.t7`` interop of the port against the JAX package's, on the CPU.

Three models, built in both packages from the same numpy-seeded trees
(shapes from ``jax.eval_shape``, carried over with ``params_from_jax`` and
``state_from_jax``): a CIFAR ResNet-20 (shortcut B, NCHW), an MLP that runs
every class of ``torch_module``'s parameter-free table beside
``BatchNormalization``, ``Dropout``, ``Reshape``, ``ReLU``, ``ReLU6``,
``HardTanh`` and ``Threshold``, and a small convnet with
``SpatialZeroPadding``, a ceil-mode ``SpatialMaxPooling``, ``Concat``,
``SpatialAveragePooling`` and ``View``.  Each way:

- the JAX package's ``save_model`` file is read by the port's
  ``load_model``, and the port's by the JAX package's (its modules
  initialised leaves first, see :func:`jax_load`); the loaded model's
  eval output agrees with the saved one's (the JAX forward against the
  port's within 1e-6 of the output's largest magnitude: their convolutions
  and matrix products sum in their own orders; a model loaded into its own
  package bit for bit);
- the two packages' files from the same weights are byte-identical.

Also: the reader keeps aliases (a tensor written twice is one object read
back), a ``torch.Tensor`` writes the bytes of its numpy twin, and
``load_model`` defaults to CUDA and raises without it; an unsupported class
and a channels-last model raise with the class's name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.resnet import resnet as jax_resnet
from bigdl_tpu.utils import torch_file as jax_torch_file
from bigdl_tpu.utils import torch_module as jax_torch_module
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.utils import torch_file, torch_module
from bigdl_tpu_torch.utils.convert import params_from_jax, state_from_jax

RTOL = 1e-6   # of the output's largest magnitude


def close(a, ref):
    np.testing.assert_allclose(a, ref, rtol=0,
                               atol=RTOL * np.abs(ref).max())


def mlp(nn):
    """Every parameter-free class of the table, and the rest of the
    element-wise ones the loaders map."""
    def branch(*mods):
        s = nn.Sequential()
        for m in mods:
            s.add(m)
        return s
    return (nn.Sequential()
            .add(nn.Reshape([8])).add(nn.Linear(8, 16))
            .add(nn.BatchNormalization(16)).add(nn.ReLU())
            .add(nn.Dropout(0.3)).add(nn.Linear(16, 16))
            .add(nn.ConcatTable().add(nn.Tanh())
                 .add(branch(nn.Abs(), nn.Sqrt())).add(nn.SoftSign()))
            .add(nn.FlattenTable()).add(nn.CAddTable())
            .add(nn.ConcatTable().add(nn.Sigmoid()).add(nn.TanhShrink())
                 .add(branch(nn.SoftSign(), nn.Exp()))
                 .add(branch(nn.Square(), nn.LogSigmoid()))
                 .add(nn.SoftPlus()).add(nn.Identity()).add(nn.ReLU6())
                 .add(nn.HardTanh(-0.5, 0.5)).add(nn.Threshold(0.1, 0.0)))
            .add(nn.CAddTable()).add(nn.Linear(16, 5))
            .add(nn.ConcatTable().add(nn.LogSoftMax()).add(nn.SoftMax()))
            .add(nn.CAddTable()))


def convnet(nn, **kw):
    return (nn.Sequential()
            .add(nn.SpatialZeroPadding(1, 2, 0, 1))
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **kw))
            .add(nn.SpatialBatchNormalization(4, **kw)).add(nn.ReLU())
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.Concat(2).add(nn.Identity())
                 .add(nn.SpatialConvolution(4, 2, 1, 1, **kw)))
            .add(nn.SpatialAveragePooling(2, 2, 2, 2))
            .add(nn.View(36).set_num_input_dims(3))
            .add(nn.Linear(36, 3, **kw)).add(nn.LogSoftMax()))


MODELS = {
    "resnet20": (lambda: jax_resnet(10, 20, layout="NCHW"),
                 lambda: resnet(10, 20, layout="NCHW", device="cpu"),
                 (2, 3, 32, 32)),
    "mlp": (lambda: mlp(jnn), lambda: mlp(pnn), (4, 2, 4)),
    "convnet": (lambda: convnet(jnn), lambda: convnet(pnn, device="cpu"),
                (2, 3, 9, 10)),
}


def numpy_trees(jm, seed=0):
    """4-D kernels He-normal, 2-D weights N(0, 1/fan_in), BN weights and
    running variances U(0.5, 1.5), other vectors N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if len(s.shape) == 4:
            w = rng.standard_normal(s.shape) * np.sqrt(
                2 / np.prod(s.shape[:3]))
        elif len(s.shape) == 2:
            w = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        elif path[-1].key in ("weight", "running_var"):
            w = rng.uniform(0.5, 1.5, s.shape)
        else:
            w = 0.1 * rng.standard_normal(s.shape)
        return w.astype(np.float32)

    return tuple(jax.tree_util.tree_map_with_path(draw, jax.eval_shape(f))
                 for f in (lambda: jm._init_params(jax.random.PRNGKey(0)),
                           jm._init_state))


def pair(name):
    """The model in both packages with the same trees, in eval mode, and
    an input."""
    make_j, make_p, shape = MODELS[name]
    jm, pm = make_j(), make_p()
    params, state = numpy_trees(jm)
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    jm._grads = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    jm._adopt()
    params_from_jax(params, pm)
    state_from_jax(state, pm)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    return jm.evaluate(), pm.evaluate(), x


def jax_load(path):
    """The JAX package's ``load_model``, its modules initialised leaves
    first.  Its loader gives the loaded BatchNorms their statistics, but a
    container whose children are all containers (a ResNet stage) finds no
    initialised child at its first forward and draws the whole subtree
    afresh, statistics included (``Container._ensure_init``): initialised
    bottom-up, every container adopts its children's trees, as the loader
    means."""
    def init(m):
        for c in getattr(m, "children", ()):
            init(c)
        m._ensure_init()
    m = jax_torch_module.load_model(path)
    init(m)
    return m


def port_out(pm, x):
    with torch.no_grad():
        return pm(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_file_loads_in_the_port(name, tmp_path):
    jm, pm, x = pair(name)
    path = str(tmp_path / "m.t7")
    jax_torch_module.save_model(path, jm)
    loaded = torch_module.load_model(path, device="cpu").evaluate()
    ref = np.asarray(jm.forward(jnp.asarray(x)))
    close(port_out(loaded, x), ref)
    np.testing.assert_array_equal(port_out(loaded, x), port_out(pm, x))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_file_loads_in_jax(name, tmp_path):
    jm, pm, x = pair(name)
    path = str(tmp_path / "m.t7")
    torch_module.save_model(path, pm)
    loaded = jax_load(path).evaluate()
    out = np.asarray(loaded.forward(jnp.asarray(x)))
    close(out, port_out(pm, x))
    np.testing.assert_array_equal(out, np.asarray(jm.forward(jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_files_are_byte_identical(name, tmp_path):
    jm, pm, _ = pair(name)
    jpath, ppath = str(tmp_path / "j.t7"), str(tmp_path / "p.t7")
    jax_torch_module.save_model(jpath, jm)
    torch_module.save_model(ppath, pm)
    with open(jpath, "rb") as fj, open(ppath, "rb") as fp:
        assert fj.read() == fp.read()


def test_reader_keeps_aliases_and_tensors_write_as_arrays(tmp_path):
    w = np.arange(6, dtype=np.float32).reshape(2, 3)

    def table(lib, a, b):
        return {"a": a, "b": b, "n": 3, "s": "x", "f": True,
                "l": [1.5, lib.LongStorage([2, 3])]}

    def saved(lib, obj):
        path = str(tmp_path / "t.t7")
        lib.save(path, obj)
        with open(path, "rb") as f:
            return f.read()

    mine = saved(torch_file, table(torch_file, w, w))
    assert mine == saved(jax_torch_file, table(jax_torch_file, w, w))
    t = torch.from_numpy(w)
    assert saved(torch_file, table(torch_file, t, t)) == mine
    torch_file.save(str(tmp_path / "t.t7"), table(torch_file, w, w))
    back = torch_file.load(str(tmp_path / "t.t7"))
    assert back["a"] is back["b"]
    np.testing.assert_array_equal(back["a"], w)
    assert back["n"] == 3 and back["s"] == "x" and back["f"] is True
    assert back["l"][0] == 1.5
    np.testing.assert_array_equal(back["l"][1], [2, 3])


def test_load_model_defaults_to_cuda_and_refuses(tmp_path):
    path = str(tmp_path / "m.t7")
    torch_module.save_model(path, pnn.Sequential().add(pnn.Tanh()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_module.load_model(path)
    with pytest.raises(ValueError, match="PReLU"):
        torch_module.save_model(path, pnn.Sequential().add(pnn.PReLU()))
    with pytest.raises(ValueError, match="NCHWToNHWC"):
        torch_module.save_model(path, resnet(10, 8, device="cpu"))
    jax_torch_file.save(path, jax_torch_file.TorchObject(
        "nn.SpatialFullConvolution", {}))
    with pytest.raises(ValueError, match="nn.SpatialFullConvolution"):
        torch_module.load_model(path, device="cpu")
