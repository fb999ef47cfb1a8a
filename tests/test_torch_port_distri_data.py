"""Sharded datasets, the all-reduce geometry and ``DistriOptimizer``'s checks
that need one process, held against the JAX package.

Split from ``test_torch_port_distri.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.dataset.dataset import ShardedDataSet as JaxShardedDataSet
from bigdl_tpu.dataset.sample import Sample as JaxSample
from bigdl_tpu.parallel import AllReduceParameter as JaxAllReduceParameter
from bigdl_tpu.utils import config as jconfig
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.dataset import Sample, SampleToMiniBatch, ShardedDataSet
from bigdl_tpu_torch.engine import allgather_sum, Engine
from bigdl_tpu_torch.optim import LocalOptimizer, max_iteration, Optimizer, SGD
from bigdl_tpu_torch.parallel import AllReduceParameter, DistriOptimizer
from bigdl_tpu_torch.utils import config as pconfig

from test_torch_port_distri import (_mlp, _mlp_samples, group1, properties,
                                    SEED, seeded)


@pytest.mark.parametrize("global_shuffle", [True, False])
@pytest.mark.parametrize("partitions", [1, 2, 4])
def test_sharded_dataset_order_matches_jax(partitions, global_shuffle):
    """Each partition's records, epoch by epoch, as the JAX package's."""
    ids = np.arange(24, dtype=np.float32)
    orders = []
    with seeded(SEED):
        for cls in (JaxShardedDataSet, ShardedDataSet):
            ds = cls(list(ids), partitions, global_shuffle=global_shuffle)
            epochs = []
            for _ in range(3):
                ds.shuffle()
                epochs.append([list(ds.shard_data(p, train=False))
                               for p in range(partitions)])
            assert ds.size() == 24
            orders.append(epochs)
    assert orders[0] == orders[1]
    assert orders[1][0] != orders[1][1]      # the epochs are reshuffled


def test_sharded_dataset_remainder_local_partitions_and_key():
    for cls in (JaxShardedDataSet, ShardedDataSet):
        ds = cls(list(range(26)), 4, local_partitions=[1, 3])
        assert (ds.size(), ds.dropped_records, ds.local_partitions,
                sorted(ds.shards)) == (24, 2, [1, 3], [1, 3])
        with pytest.raises(ValueError, match="not local"):
            ds.shard_data(0, train=True)
        with pytest.raises(ValueError, match="subset"):
            cls(list(range(8)), 2, local_partitions=[2])
    with properties([jconfig, pconfig],
                    bigdl__elastic__globalShuffle=False):
        assert not JaxShardedDataSet(list(range(8)), 2).global_shuffle
        assert not ShardedDataSet(list(range(8)), 2).global_shuffle


def test_sample_to_minibatch_partition_split_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((10, 3)).astype(np.float32)
    got = []
    for s2b, sample in ((JaxSampleToMiniBatch, JaxSample),
                        (SampleToMiniBatch, Sample)):
        batches = list(s2b(12, 3)(iter(sample(r, np.float32(1)) for r in x)))
        got.append([np.asarray(b.get_input()) for b in batches])
        with pytest.raises(ValueError, match="divisible"):
            s2b(10, 3)
    assert [b.shape for b in got[1]] == [(4, 3), (4, 3), (2, 3)]
    for a, b in zip(*got, strict=True):
        np.testing.assert_array_equal(a, b)
    assert SampleToMiniBatch(8).batch_per_partition == 8
    # ragged samples are padded to the longest of the partition's batch
    ragged = [(np.ones(n, np.float32), np.float32(1)) for n in (2, 3, 1, 4)]
    padded = [np.asarray(b.get_input()) for s2b, sample in (
        (JaxSampleToMiniBatch, JaxSample), (SampleToMiniBatch, Sample))
        for b in s2b(4, 2)(iter(sample(*r) for r in ragged))]
    assert [b.shape for b in padded] == [(2, 3), (2, 4)] * 2
    for a, b in zip(padded[:2], padded[2:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_all_reduce_parameter_geometry_matches_jax(n_shards):
    shapes = [(4, 5), (3,), (7, 1, 3), ()]
    jarp = JaxAllReduceParameter(
        {f"p{i}": np.zeros(s, np.float32) for i, s in enumerate(shapes)},
        n_shards)
    arp = AllReduceParameter([torch.zeros(s) for s in shapes], n_shards)
    assert (arp.size, arp.padded_size, arp.shard_size) == \
        (jarp.size, jarp.padded_size, jarp.shard_size)
    for k in (1, 2, 3, 4, 7, 100):
        assert arp.bucket_edges(k) == jarp.bucket_edges(k)
    with pytest.raises(ValueError, match="compression"):
        AllReduceParameter([torch.zeros(3)], 2, compression="fp16")


def test_bind_makes_parameters_views_in_their_memory_order():
    g = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(6, 3, 2, 2, generator=g)
                                 .to(memory_format=torch.channels_last)),
              torch.nn.Parameter(torch.randn(5, generator=g)),
              torch.nn.Parameter(torch.randn(4, 3, generator=g).t())]
    values = [p.detach().clone() for p in params]
    strides = [p.stride() for p in params]
    arp = AllReduceParameter(params, 4)
    flat = arp.bind(params)
    assert flat.shape == (arp.padded_size,) and arp.padded_size % 4 == 0
    lo, hi = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
    for p, v, st in zip(params, values, strides):
        assert torch.equal(p, v) and p.stride() == st
        assert lo <= p.data_ptr() < hi
    # each parameter's elements lie in the buffer in its memory order
    np.testing.assert_array_equal(
        flat[:params[0].numel()].numpy(),
        params[0].detach().permute(0, 2, 3, 1).reshape(-1).numpy())
    for got, p in zip(arp.unflatten(arp.flatten(values)), params):
        assert torch.equal(got, p)
    flat.zero_()
    assert all(float(p.detach().abs().sum()) == 0 for p in params)


def test_without_a_group_distri_optimizer_refuses():
    assert not dist.is_initialized()
    assert Engine.node_number() == 1 and Engine.core_number() == 1
    np.testing.assert_array_equal(allgather_sum([1.5, 2.0]), [1.5, 2.0])
    ds = ShardedDataSet(_mlp_samples(), 1)
    with pytest.raises(RuntimeError, match="Engine.init_distributed"):
        DistriOptimizer(_mlp(pnn, device="cpu"), ds, pnn.ClassNLLCriterion(),
                        device="cpu")


def test_create_dispatches_on_the_dataset_type(group1):
    crit = pnn.ClassNLLCriterion()
    local = Optimizer.create(_mlp(pnn, device="cpu"), _mlp_samples(), crit,
                             batch_size=8, device="cpu")
    assert type(local) is LocalOptimizer
    distri = Optimizer.create(_mlp(pnn, device="cpu"),
                              ShardedDataSet(_mlp_samples(), 1), crit,
                              batch_size=8, device="cpu")
    assert type(distri) is DistriOptimizer
    assert distri.dataset.shards[0].transformers[0].batch_per_partition == 8


def test_partition_count_must_match_the_group(group1):
    ds = ShardedDataSet(_mlp_samples(), 2).transform(SampleToMiniBatch(8, 2))
    opt = DistriOptimizer(_mlp(pnn, device="cpu"), ds,
                          pnn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(ValueError, match="must match"):
        opt.optimize()


def test_backend_and_compression_are_checked(group1, monkeypatch):
    ds = ShardedDataSet(_mlp_samples(), 1)
    with pytest.raises(ValueError, match="compression"):
        DistriOptimizer(_mlp(pnn, device="cpu"), ds, pnn.ClassNLLCriterion(),
                        compression="fp16", device="cpu")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="trains over gloo"):
        DistriOptimizer(_mlp(pnn, device="cpu"), ds, pnn.ClassNLLCriterion(),
                        device="cpu")


@pytest.mark.parametrize("ask", [
    "set_mesh", "bigdl.integrity.everyN", "bigdl.chaos.extraAllGather",
    "bigdl.chaos.dropBucketCollective", "bigdl.elastic.handleSignals"])
def test_unported_features_raise(group1, ask):
    ds = ShardedDataSet(_mlp_samples(), 1).transform(SampleToMiniBatch(8))
    opt = DistriOptimizer(_mlp(pnn, device="cpu"), ds,
                          pnn.ClassNLLCriterion(), device="cpu")
    opt.set_end_when(max_iteration(1))
    if ask == "set_mesh":
        # every axis of the JAX package is ported now: a seq mesh is taken
        # (its batches must be (N, T, ...): the MLP's labels are not), an
        # unknown axis raises
        with pytest.raises(ValueError, match="expected 'data'"):
            opt.set_mesh(Engine.create_mesh((1, 1), ("data", "bogus")))
        assert opt.set_mesh(Engine.create_mesh(
            (1, 1), ("data", "seq"))).seq_axis == "seq"
        with pytest.raises(ValueError, match=r"needs \(N, T, ...\)"):
            opt.optimize()
        assert opt.history == []
        return
    value = True if ask.endswith(("Gather", "Signals")) else 1
    if ask in ("bigdl.integrity.everyN", "bigdl.elastic.handleSignals"):
        # ported now: the fingerprint verdict is checked every step, and
        # the SIGTERM handler is installed for the run and put back after
        import signal
        from bigdl_tpu_torch import telemetry
        checks = telemetry.counter("Integrity/checks").value
        prev = signal.getsignal(signal.SIGTERM)
        with properties([pconfig], **{ask.replace(".", "__"): value}):
            opt.optimize()
        assert len(opt.history) == 1
        assert signal.getsignal(signal.SIGTERM) == prev
        assert telemetry.counter("Integrity/checks").value == \
            checks + (ask == "bigdl.integrity.everyN")
        return
    with properties([pconfig], **{ask.replace(".", "__"): value}):
        with pytest.raises(NotImplementedError, match="not ported"):
            opt.optimize()
    assert opt.history == []


@pytest.mark.parametrize("overlap", [True, False])
def test_one_rank_is_local_optimizer_bit_for_bit(group1, overlap):
    """At one rank the reduce-scatter is a copy and the division by 1
    exact: the trainers agree to the bit on the same rows in the same
    order (a 1-partition ShardedDataSet feeds both)."""
    samples = _mlp_samples(32)
    runs = []
    for cls in (LocalOptimizer, DistriOptimizer):
        model = _mlp(pnn, device="cpu")
        ds = ShardedDataSet(samples, 1).transform(SampleToMiniBatch(8))
        with seeded(SEED), properties([pconfig],
                                      bigdl__parallel__overlap=overlap):
            opt = cls(model, ds, pnn.ClassNLLCriterion(), device="cpu")
            opt.set_optim_method(SGD(0.2, momentum=0.9))
            opt.set_end_when(max_iteration(6)).optimize()
        runs.append(([h["loss"] for h in opt.history],
                     [p.detach() for p in model.parameters()],
                     opt.optim_method._slots["dfdx"]))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert l0 == l1
    for a, b in zip(p0 + s0, p1 + s1):
        assert torch.equal(a, b)
