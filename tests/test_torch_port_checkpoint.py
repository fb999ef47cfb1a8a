"""The port's training contract held against the JAX package, on the CPU:
verified checkpoints, restore, resume and retry, and the model-zoo drivers.

- The cases of ``tests/test_checkpoint_manager.py`` over the port's
  ``CheckpointManager`` (one parametrised test): manifest and commit, the
  pair required, uncommitted, truncated, bit-flipped and fingerprint-
  corrupt snapshots skipped, legacy pairs, ``keep_last`` GC, the orphan
  sweep, the asynchronous writer and its deferred errors, a detached
  capture, a newer schema refused, remote paths refused.
- The same file names and manifest keys as the JAX manager writes for the
  same snapshot.
- A cross-package restore: the JAX package trains an MLP (SGD with
  momentum) one epoch and checkpoints; its snapshot is loaded through
  ``bigdl_tpu`` and carried into the port (``params_from_jax``; the slots
  share the parameters' tree); the port trains one more epoch, against
  the JAX package continuing from its own snapshot: atol 1e-5 on weights
  and momentum, as ``tests/test_torch_port_training.py`` holds SGD with
  momentum.
- On a ``ShardedDataSet`` through ``DistriOptimizer`` over a one-rank gloo
  group (a conv + BatchNorm model): two epochs straight, one epoch then a
  fresh trainer resumed from the snapshot, and two epochs with a failure
  injected at batch 4 (after step 3 moved past the snapshot) and retried
  from the snapshot end bit-identical; with no snapshot, a retry goes on
  from the live state, bit-identical to ``LocalOptimizer``'s.
- The retry budget, the backoff against the JAX package's, a topology
  change, the async writer's thread joined by ``optimize()``.
- The LeNet driver (``--synthetic 256 -e 2 --checkpoint``, then
  ``--model/--state`` resume) and ``lenet/test.py`` with ``--device cpu``;
  the ResNet, VGG, Inception and transformer drivers trained a few
  iterations (the ResNet and LM ones checkpointing); every refused flag
  raising ``NotImplementedError``.

Each test reseeds both packages' ``RandomGenerator`` and puts back the
previous thread-local ones, restores the config keys it sets and the
loggers a driver's logging bootstrap redirects.
"""

import contextlib
import json
import logging
import os
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset.datasets import \
    synthetic_separable as jax_synthetic_separable
from bigdl_tpu.utils import elastic as jelastic
from bigdl_tpu.utils.checkpoint_manager import \
    CheckpointManager as JaxCheckpointManager
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
from bigdl_tpu.visualization.crc32c import crc32c as jax_crc32c
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.optim as poptim
from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, ShardedDataSet
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.optim import optim_method as pom
from bigdl_tpu_torch.parallel import DistriOptimizer
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils import elastic, file_io
from bigdl_tpu_torch.utils import checkpoint_manager as cm
from bigdl_tpu_torch.utils.checkpoint_manager import (CheckpointManager,
                                                      SnapshotCorruptError,
                                                      SnapshotSchemaError,
                                                      SnapshotWriteError,
                                                      load_file)
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_from_jax)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.visualization.crc32c import crc32c

ATOL = 1e-5


@contextlib.contextmanager
def seeded(seed):
    """Both packages' thread-local RandomGenerator replaced by a fresh one
    seeded with ``seed``; the previous ones are put back after."""
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


@contextlib.contextmanager
def properties(**keys):
    """Set the port's config keys (dots as ``__``), restore them after."""
    saved = []
    for key, value in keys.items():
        name = key.replace("__", ".")
        saved.append((name, name in pconfig._OVERRIDES,
                      pconfig._OVERRIDES.get(name)))
        pconfig.set_property(name, value)
    try:
        yield
    finally:
        for name, had, value in saved:
            if had:
                pconfig.set_property(name, value)
            else:
                pconfig.clear_property(name)


def _mlp(mod, **kw):
    return (mod.Sequential().add(mod.Linear(4, 8, **kw)).add(mod.Tanh())
            .add(mod.Linear(8, 2, **kw)).add(mod.LogSoftMax()))


def _port_mlp(seed=5):
    g = torch.Generator().manual_seed(seed)
    return (pnn.Sequential().add(pnn.Linear(4, 8, device="cpu", generator=g))
            .add(pnn.Tanh()).add(pnn.Linear(8, 2, device="cpu", generator=g))
            .add(pnn.LogSoftMax()))


def _sgd(model=None):
    sgd = poptim.SGD(learning_rate=0.1, momentum=0.9)
    if model is not None:
        sgd.set_slots({"dfdx": [p.detach() * 0.5 for p in model.parameters()]})
    return sgd


def _kept(path):
    return {int(f.split(".")[1]) for f in os.listdir(path)}


def _params(model):
    return [t.detach().clone() for t in model.state_dict().values()]


# ------------------------------------------- the manager's cases, one test

def case_manifest_and_commit(tmp_path):
    CheckpointManager(str(tmp_path)).save(_port_mlp(), _sgd(), 3)
    assert sorted(os.listdir(tmp_path)) == ["commit.3", "manifest.3",
                                            "model.3", "optimMethod.3"]
    manifest = json.loads((tmp_path / "manifest.3").read_bytes())
    assert manifest["neval"] == 3 and manifest["version"] == 3
    for fname in ("model.3", "optimMethod.3"):
        data = (tmp_path / fname).read_bytes()
        assert manifest["files"][fname]["bytes"] == len(data)
        assert manifest["files"][fname]["checksum"] == \
            cm.checksum_by_algo(manifest["algo"], data)
    mbytes = (tmp_path / "manifest.3").read_bytes()
    assert (tmp_path / "commit.3").read_text().strip() == \
        f"{crc32c(mbytes):08x}"


def case_pair_required(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 3)
    file_io.save(cm.model_payload(_port_mlp()), str(tmp_path / "model.7"))
    path_m, _, n = mgr.latest_valid()
    assert n == 3 and path_m.endswith("model.3")


def case_skips_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 1)
    mgr.save(_port_mlp(), _sgd(), 2)
    os.unlink(tmp_path / "commit.2")
    assert mgr.latest_valid()[2] == 1 and mgr.load_latest()[2] == 1


def case_skips_truncated(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 1)
    mgr.save(_port_mlp(), _sgd(), 2)
    data = (tmp_path / "model.2").read_bytes()
    (tmp_path / "model.2").write_bytes(data[:len(data) // 2])
    assert mgr.latest_valid()[2] == 1 and mgr.load_latest()[2] == 1


def case_skips_bitflip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 1)
    sgd = _sgd()
    sgd.state["evalCounter"] = 2
    mgr.save(_port_mlp(), sgd, 2)
    data = bytearray((tmp_path / "model.2").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (tmp_path / "model.2").write_bytes(bytes(data))
    _, optim, n = mgr.load_latest()
    assert n == 1 and optim["state"]["evalCounter"] == 0
    assert not mgr.verify(2, True, deep=True)
    with pytest.raises(SnapshotCorruptError, match="checksum"):
        load_file(str(tmp_path / "model.2"))


def case_fingerprint_refuses_state_corrupt_before_the_write(tmp_path):
    """A payload whose checksum verifies but whose values differ from the
    save-time fingerprint (memory rot before serialization) is refused."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 1)
    mgr.save(_port_mlp(), _sgd(), 2)
    payload = file_io.load(str(tmp_path / "model.2"))
    next(iter(payload.values())).view(-1)[0] += 1.0
    data = file_io.dumps(payload)
    (tmp_path / "model.2").write_bytes(data)
    manifest = json.loads((tmp_path / "manifest.2").read_bytes())
    manifest["files"]["model.2"].update(
        bytes=len(data),
        checksum=cm.checksum_by_algo(manifest["algo"], data))
    mbytes = json.dumps(manifest, sort_keys=True).encode()
    (tmp_path / "manifest.2").write_bytes(mbytes)
    (tmp_path / "commit.2").write_text(f"{crc32c(mbytes):08x}\n")
    assert mgr.latest_valid()[2] == 2          # the shallow check passes
    assert mgr.load_latest()[2] == 1
    with pytest.raises(SnapshotCorruptError, match="fingerprint"):
        load_file(str(tmp_path / "model.2"))


def case_reads_a_crc32c_manifest(tmp_path):
    """The port writes CRC32; a manifest with ``algo`` CRC32C (the JAX
    package's where a native CRC32C is installed) verifies, and a bit
    flip under it is still caught."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 1)
    mgr.save(_port_mlp(), _sgd(), 2)
    manifest = json.loads((tmp_path / "manifest.2").read_bytes())
    assert manifest["algo"] == "crc32"
    manifest["algo"] = "crc32c"
    for fname, meta in manifest["files"].items():
        meta["checksum"] = jax_crc32c((tmp_path / fname).read_bytes())
    mbytes = json.dumps(manifest, sort_keys=True).encode()
    (tmp_path / "manifest.2").write_bytes(mbytes)
    (tmp_path / "commit.2").write_text(f"{crc32c(mbytes):08x}\n")
    assert mgr.verify(2, True, deep=True) and mgr.load_latest()[2] == 2
    data = bytearray((tmp_path / "optimMethod.2").read_bytes())
    data[len(data) // 2] ^= 0x01
    (tmp_path / "optimMethod.2").write_bytes(bytes(data))
    assert not mgr.verify(2, True, deep=True)
    assert mgr.load_latest()[2] == 1


def case_legacy_pair_restorable(tmp_path):
    model = _port_mlp(seed=9)
    file_io.save(cm.model_payload(model), str(tmp_path / "model.4"))
    file_io.save(pom.optim_payload(_sgd(model)),
                 str(tmp_path / "optimMethod.4"))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_valid()[2] == 4
    mp, op, n = mgr.load_latest()
    fresh = _port_mlp(seed=1)
    fresh.load_state_dict(mp)
    assert n == 4 and all(torch.equal(a, b) for a, b in
                          zip(_params(fresh), _params(model)))
    assert len(op["slots"]["dfdx"]) == 4


def case_falls_back_when_loading_fails(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 3)
    (tmp_path / "model.9").write_bytes(b"not a payload")
    file_io.save(pom.optim_payload(_sgd()), str(tmp_path / "optimMethod.9"))
    assert mgr.load_latest()[2] == 3


def case_empty_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    assert mgr.latest_valid() is None and mgr.load_latest() is None


def case_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for n in range(1, 6):
        mgr.save(_port_mlp(), _sgd(), n)
    assert _kept(tmp_path) == {4, 5} and len(os.listdir(tmp_path)) == 8
    assert mgr.latest_valid()[2] == 5


def case_gc_never_counts_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    mgr.save(_port_mlp(), _sgd(), 1)
    mgr.save(_port_mlp(), _sgd(), 2)
    os.unlink(tmp_path / "commit.2")
    mgr.save(_port_mlp(), _sgd(), 3)
    assert _kept(tmp_path) == {1, 3} and mgr.latest_valid()[2] == 3


def case_gc_bounds_legacy_snapshots(tmp_path):
    for n in range(1, 6):
        file_io.save(cm.model_payload(_port_mlp()),
                     str(tmp_path / f"model.{n}"))
        file_io.save(pom.optim_payload(_sgd()),
                     str(tmp_path / f"optimMethod.{n}"))
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    mgr.save(_port_mlp(), _sgd(), 6)
    assert _kept(tmp_path) == {5, 6} and mgr.load_latest()[2] == 6


def case_gc_sweeps_torn_debris(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    mgr.save(_port_mlp(), _sgd(), 1)
    (tmp_path / "model.2").write_bytes(b"torn, writer died")
    mgr.save(_port_mlp(), _sgd(), 3)
    mgr.save(_port_mlp(), _sgd(), 4)
    assert "model.2" not in os.listdir(tmp_path)
    assert _kept(tmp_path) == {3, 4}


def case_gc_never_evicts_the_last_valid(tmp_path):
    writer = CheckpointManager(str(tmp_path))
    writer.save(_port_mlp(), _sgd(), 1)
    writer.save(_port_mlp(), _sgd(), 2)
    data = (tmp_path / "model.2").read_bytes()
    (tmp_path / "model.2").write_bytes(data[:len(data) // 2])
    mgr = CheckpointManager(str(tmp_path), keep_last=1)
    mgr.gc()
    assert (tmp_path / "model.1").exists() and mgr.load_latest()[2] == 1
    mgr.save(_port_mlp(), _sgd(), 3)
    assert _kept(tmp_path) == {3}


def case_keep_all_by_default(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for n in range(1, 5):
        mgr.save(_port_mlp(), _sgd(), n)
    assert _kept(tmp_path) == {1, 2, 3, 4}


def case_orphan_temps_swept_by_age(tmp_path):
    old, young = tmp_path / ".tmp_bigdl_old", tmp_path / ".tmp_bigdl_new"
    old.write_bytes(b"x")
    young.write_bytes(b"y")
    past = time.time() - 2 * CheckpointManager.TEMP_SWEEP_AGE_S
    os.utime(old, (past, past))
    CheckpointManager(str(tmp_path)).save(_port_mlp(), _sgd(), 1)
    assert not old.exists() and young.exists()


def case_async_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    model = _port_mlp(seed=3)
    mgr.save(model, _sgd(model), 1)
    mgr.join()
    assert sorted(os.listdir(tmp_path)) == ["commit.1", "manifest.1",
                                            "model.1", "optimMethod.1"]
    mp, op, _ = mgr.load_latest()
    assert all(torch.equal(a, b) for a, b in zip(mp.values(), _params(model)))
    assert mgr.verify(1, True, deep=True)


def _failing_first_write(monkeypatch):
    real = file_io.write_bytes
    calls = {"n": 0}

    def write(path, data, overwrite=True):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("the writer died")
        return real(path, data, overwrite)

    monkeypatch.setattr(file_io, "write_bytes", write)


def case_writer_error_at_next_save(tmp_path, monkeypatch):
    _failing_first_write(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(_port_mlp(), _sgd(), 1)
    with pytest.raises(SnapshotWriteError):
        mgr.save(_port_mlp(), _sgd(), 2)


def case_writer_error_at_join(tmp_path, monkeypatch):
    _failing_first_write(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(_port_mlp(), _sgd(), 1)
    with pytest.raises(SnapshotWriteError):
        mgr.join()
    mgr.join()     # consumed: a second join is clean


def case_capture_is_detached(tmp_path):
    model, sgd = _port_mlp(), _sgd()
    sgd.state["evalCounter"] = 7
    before = _params(model)
    blobs, _ = cm._capture(model, sgd, 7)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    sgd.state["evalCounter"] = 99
    snap = file_io.loads(blobs["model.7"])
    assert all(torch.equal(a, b) for a, b in zip(before, snap.values()))
    assert file_io.loads(blobs["optimMethod.7"])["state"]["evalCounter"] == 7


def case_newer_schema_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_port_mlp(), _sgd(), 1)
    manifest = json.loads((tmp_path / "manifest.1").read_bytes())
    manifest["version"] = 99
    mbytes = json.dumps(manifest, sort_keys=True).encode()
    (tmp_path / "manifest.1").write_bytes(mbytes)
    (tmp_path / "commit.1").write_text(f"{crc32c(mbytes):08x}\n")
    with pytest.raises(SnapshotSchemaError, match="newer"):
        mgr.load_latest()


def case_remote_scheme_refused(tmp_path):
    for path in ("hdfs://nn/ckpt", "s3://bucket/ckpt", "memory://ckpt"):
        with pytest.raises(NotImplementedError, match="only local paths"):
            CheckpointManager(path)


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_manager(case, tmp_path, monkeypatch):
    fn = CASES[case]
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        fn(tmp_path, monkeypatch)
    else:
        fn(tmp_path)


# ------------------------------------------------ against the JAX package

def _jax_mlp(seed=5):
    m = _mlp(jnn)
    m.reset(jax.random.PRNGKey(seed))
    return m


def test_file_names_and_manifest_keys_match_jax(tmp_path):
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JaxCheckpointManager(str(jdir)).save(
        _jax_mlp(), joptim.SGD(learning_rate=0.1, momentum=0.9), 3,
        topology=jelastic.describe_topology(step="local"))
    CheckpointManager(str(pdir)).save(
        _port_mlp(), _sgd(), 3, topology=elastic.describe_topology())
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    jm, pm = (json.loads((d / "manifest.3").read_bytes())
              for d in (jdir, pdir))
    assert sorted(jm) == sorted(pm)
    assert jm["version"] == pm["version"] and jm["neval"] == pm["neval"]
    assert sorted(jm["files"]) == sorted(pm["files"])
    for name in jm["files"]:
        assert sorted(jm["files"][name]) == sorted(pm["files"][name])
    assert jm["topology"] == pm["topology"]
    for d in (jdir, pdir):
        assert (d / "commit.3").read_text().strip() == \
            f"{crc32c((d / 'manifest.3').read_bytes()):08x}"


def test_a_jax_snapshot_continues_in_the_port_like_jax(tmp_path):
    """The JAX package trains one epoch and checkpoints; both packages
    continue one epoch from that snapshot."""
    records = jax_synthetic_separable(32, 4, n_classes=2, seed=3)
    jm = _jax_mlp(seed=7)
    with seeded(20):
        opt = joptim.Optimizer.create(jm, records, jnn.ClassNLLCriterion(),
                                      batch_size=8)
        opt.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
        opt.set_checkpoint(str(tmp_path), joptim.every_epoch())
        opt.set_end_when(joptim.max_epoch(1)).optimize()
    jmodel, joptim_method, n = JaxCheckpointManager(
        str(tmp_path)).load_latest()
    assert n == 4 and joptim_method.state["epoch"] == 2
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pm = params_from_jax(np_tree(jmodel.params), _mlp(pnn, device="cpu"))
    state_from_jax(np_tree(jmodel.state), pm)
    slots = params_from_jax(np_tree(joptim_method._slots["dfdx"]),
                            _mlp(pnn, device="cpu"))
    psgd = poptim.SGD(learning_rate=0.1, momentum=0.9)
    psgd.state = dict(joptim_method.state)
    psgd.set_slots({"dfdx": [p.detach() for p in slots.parameters()]})
    port_records = [Sample(s.features[0], s.labels[0]) for s in records]
    with seeded(21):
        for model, mod, nn_mod, recs, method, kw in (
                (jmodel, joptim, jnn, records, joptim_method, {}),
                (pm, poptim, pnn, port_records, psgd, {"device": "cpu"})):
            opt = mod.Optimizer.create(model, recs,
                                       nn_mod.ClassNLLCriterion(),
                                       batch_size=8, **kw)
            opt.set_optim_method(method)
            opt.set_end_when(mod.max_epoch(2)).optimize()
    assert psgd.state["evalCounter"] == joptim_method.state["evalCounter"] \
        == 8
    for p, j in zip(jax.tree_util.tree_leaves(params_to_jax(pm)),
                    jax.tree_util.tree_leaves(np_tree(jmodel.params))):
        np.testing.assert_allclose(p, j, atol=ATOL, rtol=0)
    mom = params_from_jax(np_tree(joptim_method._slots["dfdx"]),
                          _mlp(pnn, device="cpu"))
    for p, j in zip(psgd._slots["dfdx"], mom.parameters()):
        np.testing.assert_allclose(p.numpy(), j.detach().numpy(), atol=ATOL,
                                   rtol=0)


# ----------------------------------- resume and retry on a sharded dataset

@pytest.fixture
def group1(tmp_path):
    """A gloo process group of one rank in this process, destroyed
    after."""
    Engine.init_distributed(init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _conv_bn():
    g = torch.Generator().manual_seed(11)
    kw = dict(device="cpu", generator=g)
    return (pnn.Sequential().add(pnn.Reshape((1, 8, 8)))
            .add(pnn.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1, **kw))
            .add(pnn.SpatialBatchNormalization(4, device="cpu"))
            .add(pnn.ReLU()).add(pnn.Reshape((4 * 8 * 8,)))
            .add(pnn.Linear(4 * 8 * 8, 2, **kw)).add(pnn.LogSoftMax()))


def _digit_samples(n=16):
    rng = np.random.RandomState(12)
    return [Sample(rng.normal(0, 1, (8, 8)).astype(np.float32),
                   np.float32(rng.randint(1, 3))) for _ in range(n)]


def _sharded(samples):
    return ShardedDataSet(samples, 1).transform(SampleToMiniBatch(8))


def _fail_once_at(ds, n):
    """Make the ``n``-th minibatch drawn from ``ds``'s partitions raise,
    once."""
    real, count = ds.shard_data, {"n": 0}

    def shard_data(p, train):
        for batch in real(p, train):
            count["n"] += 1
            if count["n"] == n:
                raise OSError(f"injected failure at batch {n}")
            yield batch

    ds.shard_data = shard_data
    return ds


def _distri(model, ds, method=None):
    opt = DistriOptimizer(model, ds, pnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(method or poptim.SGD(learning_rate=0.1,
                                              momentum=0.9))
    return opt


def _trained_state(opt):
    return ([t.detach().clone() for t in opt.model.state_dict().values()] +
            list(opt.optim_method._slots["dfdx"]))


def _failing_data(ds, fail):
    """``ds.data`` whose n-th minibatch drawn raises where ``fail(n)``;
    returns the list of the draws that raised."""
    real, count, raised = ds.data, {"n": 0}, []

    def data(train):
        for batch in real(train):
            count["n"] += 1
            if fail(count["n"]):
                raised.append(count["n"])
                raise OSError(f"injected at draw {count['n']}")
            yield batch

    ds.data = data
    return raised


# --------------------------------------------------------------- drivers

@pytest.fixture
def driver_logging(tmp_path):
    """The driver's logging bootstrap writes to ``tmp_path``; the port's
    logger is put back after."""
    lg = logging.getLogger("bigdl_tpu_torch")
    saved = (list(lg.handlers), lg.level, lg.propagate)
    with properties(bigdl__utils__LoggerFilter__logFile=str(
            tmp_path / "bigdl.log")):
        yield
    for h in lg.handlers:
        if h not in saved[0]:
            h.close()
    lg.handlers, lg.level, lg.propagate = saved[0], saved[1], saved[2]
