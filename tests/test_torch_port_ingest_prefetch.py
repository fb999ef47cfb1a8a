"""The device head, padded batching, the file loaders and the batch
prefetcher, held against the JAX package.

Split from ``test_torch_port_ingest.py``,
whose docstring states what is held against the JAX package and with which
tolerances; the helpers and fixtures come from there.  No test file of the
port holds more than 25 tests: pytest-xdist's ``loadfile`` scheduler hands
out the largest files first (ROADMAP.md, standing rules).
"""

import gzip
import struct
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import (datasets as jdatasets, sample as jsample,
                               text as jtext, transformer as jtransformer)
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.dataset import (datasets, image, mt_batch, PaddingParam,
                                     Sample, SampleToMiniBatch,
                                     StreamingIngest, text)
from bigdl_tpu_torch.engine import BatchPrefetcher, DispatchPipeline
from bigdl_tpu_torch.utils.random_generator import RandomGenerator

from test_torch_port_ingest import (_epoch_fetch, _live, _prefetch_threads,
                                    _records, _same_state, _threads_before,
                                    _train_port, conv_bn_jax, CROP, entries,
                                    HW, SEED, seeded)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_device_head_matches_jax(fmt):
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (6,) + HW + (3,)).astype(np.uint8)
    offs = np.stack([rng.randint(0, HW[0] - 31, 6),
                     rng.randint(0, HW[1] - 31, 6)], 1).astype(np.int32)
    flips = rng.randint(0, 2, 6).astype(np.uint8)
    got = pnn.DeviceAugment(*CROP)([torch.from_numpy(a) for a in
                                    (frames, offs, flips)])
    ref, _ = jnn.DeviceAugment(*CROP).apply(
        {}, [jnp.asarray(a) for a in (frames, offs, flips)], {})
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.is_contiguous(memory_format=torch.channels_last)
    x = np.array(ref)
    assert pnn.DeviceAugment(*CROP)(torch.from_numpy(x)) is not None
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    mean, std = (104.0, 117.0, 123.0), (58.395, 57.12, 57.375)
    for dtype, jdtype in ((None, None), (torch.bfloat16, "bfloat16")):
        out = pnn.ChannelNormalize(mean, std, dtype=dtype, format=fmt)(
            torch.from_numpy(x))
        jout, _ = jnn.ChannelNormalize(mean, std, dtype=jdtype,
                                       format=fmt).apply({}, jnp.asarray(x),
                                                         {})
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(jout).astype(np.float32))


def test_padded_sample_to_minibatch_matches_jax():
    rng = np.random.RandomState(2)
    lengths = [3, 5, 2, 4, 5]
    feats = [rng.standard_normal((n, 2)).astype(np.float32) for n in lengths]
    labs = [np.arange(n, dtype=np.float32) + 1 for n in lengths]
    for fpad, lpad in ((None, None),
                       ((-1.0, [7]), (0.0, None))):
        out = []
        for mod_s, mod_t in ((jsample, jtransformer), (None, None)):
            if mod_s is None:
                pp = PaddingParam
                s2b, smp = SampleToMiniBatch, Sample
            else:
                pp = mod_s.PaddingParam
                s2b, smp = mod_t.SampleToMiniBatch, mod_s.Sample
            kw = {} if fpad is None else {
                "feature_padding": pp(fpad[0], fpad[1]),
                "label_padding": pp(lpad[0], lpad[1])}
            batches = list(s2b(4, **kw)(iter(
                smp(f, lb) for f, lb in zip(feats, labs))))
            out.append([(np.asarray(b.get_input()), np.asarray(
                b.get_target())) for b in batches])
        for (a, b), (c, d) in zip(*out, strict=True):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    assert out[1][0][0].shape == (4, 7, 2)


def test_file_loaders_and_text_match_jax(tmp_path):
    rng = np.random.RandomState(9)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    cifar = np.concatenate([rng.randint(0, 10, (4, 1)), rng.randint(
        0, 256, (4, 3072))], 1).astype(np.uint8)
    cifar.tofile(tmp_path / "test_batch.bin")
    (tmp_path / "glove.txt").write_text("the 0.1 0.2\ncat -1 2.5\nbad 1\n")
    (tmp_path / "ratings.dat").write_text("1::10::5::978\n2::20::3::979\n")
    for a, b in ((datasets.load_mnist(str(tmp_path)),
                  jdatasets.load_mnist(str(tmp_path))),
                 (datasets.load_cifar10(str(tmp_path), "test"),
                  jdatasets.load_cifar10(str(tmp_path), "test"))):
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.data, y.data)
            assert x.label == y.label
    ga, gb = (m.load_glove(str(tmp_path / "glove.txt"), dim=2)
              for m in (datasets, jdatasets))
    assert ga.keys() == gb.keys() == {"the", "cat"}
    np.testing.assert_array_equal(datasets.load_movielens(str(tmp_path)),
                                  jdatasets.load_movielens(str(tmp_path)))
    for x, y in zip(datasets.synthetic_separable(16, 3, 3, seed=4),
                    jdatasets.synthetic_separable(16, 3, 3, seed=4)):
        np.testing.assert_array_equal(x.feature, y.feature)
        np.testing.assert_array_equal(x.label, y.label)

    para = ["The cat sat. A dog ran! Did it?", "Cats, dogs; and 'birds'."]
    out = []
    for mod in (text, jtext):
        sents = list(mod.SentenceBiPadding()(mod.SentenceSplitter()(
            iter(para))))
        toks = list(mod.SentenceTokenizer()(iter(sents)))
        d = mod.Dictionary(toks, vocab_size=6)
        labeled = list(mod.TextToLabeledSentence(d)(iter(toks)))
        samples = list(mod.LabeledSentenceToSample(
            d.vocab_size() + 1, fixed_length=8)(iter(labeled)))
        out.append((sents, toks, d.word2index, [d.get_index("zebra")],
                    [(s.feature, s.label) for s in samples]))
    assert out[0][:4] == out[1][:4]
    for (a, b), (c, e) in zip(out[0][4], out[1][4], strict=True):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)


@pytest.mark.parametrize("transfer_ahead", [1, 2])
@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_sequence_errors_threads_and_rng(depth, transfer_ahead,
                                                    _prefetch_threads):
    with seeded(11):
        fetch, on_batch = _epoch_fetch()
        want = []
        for _ in range(13):
            b = fetch()
            on_batch(b)
            want.append(b[0][:, 0].tolist())
        want_state = RandomGenerator.RNG().np.get_state()
    with seeded(11):
        fetch, on_batch = _epoch_fetch()
        pf = BatchPrefetcher(fetch, depth=depth, on_batch=on_batch,
                             transfer_ahead=transfer_ahead, device="cpu")
        try:
            got = []
            for _ in range(13):
                x, y, n = pf()
                assert isinstance(x, torch.Tensor) and n == 4
                got.append(x[:, 0].tolist())
        finally:
            pf.stop()
        # read-ahead thrown away (a reshuffle at record 60 included) does
        # not move the caller's generator
        _same_state(RandomGenerator.RNG().np.get_state(), want_state)
    assert got == want and got[0] != got[5]     # epochs reshuffled
    assert pf.batches >= 13 and pf.wait_ns > 0 and not _prefetch_threads()

    calls = {"n": 0}

    def failing():
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyError("third fetch")
        return np.zeros(2, np.float32), np.ones(1, np.float32), 1

    pf = BatchPrefetcher(failing, depth=depth, transfer_ahead=transfer_ahead,
                         device="cpu")
    try:
        pf(), pf()
        with pytest.raises(KeyError, match="third fetch"):
            pf()
    finally:
        pf.stop()
    assert not _prefetch_threads()
    calls["n"] = 1
    pf = BatchPrefetcher(failing, depth=depth, transfer_ahead=transfer_ahead,
                         device="cpu")
    pf()                   # then the consumer abandons the stream
    if depth:
        while calls["n"] < 3:
            threading.Event().wait(0.01)
    pf.stop()
    assert not _prefetch_threads()
    if depth:
        assert isinstance(pf.error, KeyError)
    else:
        assert pf.error is None


def test_prefetcher_over_streaming_ingest_keeps_caller_rng(
        entries, _prefetch_threads, _threads_before):
    """Two batches taken from a depth-2 prefetcher over the engine, then
    stopped: the caller's generator is where the synchronous path leaves it
    after two batches (the engine's and the prefetcher's read-ahead
    thrown away)."""
    recs = _records(entries, image.LabeledImageBytes)
    with seeded(SEED):
        it = mt_batch.MTLabeledBGRImgToBatch(4, crop=CROP)(iter(recs))
        want = [next(it).get_input().copy() for _ in range(2)]
        it.close()
        want_state = RandomGenerator.RNG().np.get_state()
    with seeded(SEED):
        eng = StreamingIngest(4, crop=CROP, decode_workers=2,
                              record_ring_depth=64, batch_ring_depth=4)
        src = eng(iter(recs))
        pf = BatchPrefetcher(lambda: next(src).get_input(), depth=2,
                             device="cpu")
        try:
            got = [pf().numpy() for _ in range(2)]
            threading.Event().wait(0.2)     # let both run far ahead
        finally:
            pf.stop()
            src.close()
        _same_state(RandomGenerator.RNG().np.get_state(), want_state)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert not _prefetch_threads()
    assert not _live(_threads_before, "ingest-")


def test_dispatch_pipeline_drains_in_order():
    seen = []
    pipe = DispatchPipeline(lambda item, nxt: seen.append(
        (int(item[0]), item[1], None if nxt is None else nxt[1])), depth=3)
    for i in range(5):
        pipe.push(torch.tensor(i * 10), f"m{i}")
    assert [s[1] for s in seen] == ["m0", "m1", "m2"]
    pipe.flush()
    assert seen == [(0, "m0", "m1"), (10, "m1", "m2"), (20, "m2", "m3"),
                    (30, "m3", "m4"), (40, "m4", None)]
    pipe.push(torch.tensor(1), "x")
    assert pipe.abandon() == 1


def test_local_optimizer_over_streaming_ingest(entries, conv_bn_jax,
                                               _threads_before):
    init, jparams, jstate = conv_bn_jax
    runs = {(depth, aug): _train_port(entries, init, depth, aug)
            for depth, aug in ((2, True), (0, True), (0, False))}
    ref = jax.tree_util.tree_leaves(runs[(2, True)])
    for key, run in runs.items():
        for a, b in zip(jax.tree_util.tree_leaves(run), ref, strict=True):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    for port, jx in ((runs[(2, True)][0], jparams),
                     (runs[(2, True)][1], jstate)):
        pl, jl = (jax.tree_util.tree_leaves(t) for t in (port, jx))
        assert len(pl) == len(jl) and pl
        for p, j in zip(pl, jl):
            d = np.abs(p - np.asarray(j))
            assert np.sqrt(np.mean(d ** 2)) <= 1e-4 and d.max() <= 1e-3, \
                (p.shape, np.sqrt(np.mean(d ** 2)), d.max())
    assert not _live(_threads_before, "ingest-", "prefetch-")
