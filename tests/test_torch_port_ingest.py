"""The port's real-data path held against the JAX package, on the CPU.

Inputs are made with numpy from a seed: 24 JPEGs of 40 x 48 (quality 90,
decoded by the same library in both packages), batches of 8, crops of
32 x 32.  Each comparison is bit-identical unless it says otherwise:

* SequenceFiles written by either package read the same through both
  packages' native and Python readers; a flipped length byte raises
  ``CorruptRecordError``;
* ``assemble_batch``, ``assemble_batch_u8`` and ``crop_flip_host``;
* ``MTLabeledBGRImgToBatch`` and ``StreamingIngest`` in host,
  ``device_normalize`` and ``device_augment`` modes: the first three
  batches and the caller's generator state after them, over decode workers
  1 and 3 and two ring depths;
* ``crop_flip_transpose``, ``DeviceAugment`` and ``ChannelNormalize``;
* a padded ``SampleToMiniBatch``; the idx and CIFAR loaders, the text
  pipeline;
* ``BatchPrefetcher`` over depth 0/2 x ``transfer_ahead`` 1/2: the batch
  sequence and reshuffles, errors re-raised and parked, threads joined,
  and the caller's generator left where depth 0 leaves it;
* a conv + BatchNorm model trained by ``LocalOptimizer`` over
  ``StreamingIngest``: bit-identical weights in the port across
  device-augment against host ingest and prefetch depth 0 against 2, and
  the JAX package's trained weights within 1e-4 in root mean square per
  tensor and 1e-3 in the largest entry (the tolerance of
  ``tests/test_torch_port_zoo.py`` for trained fp32 weights).

Every test puts back both packages' thread-local generators and the config
keys it sets (the tier-1 run shares worker processes).
"""

import contextlib
import gzip
import io
import struct
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import LocalDataSet as JaxLocalDataSet
from bigdl_tpu.dataset import datasets as jdatasets
from bigdl_tpu.dataset import device_augment as jaug
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import ingest as jingest
from bigdl_tpu.dataset import mt_batch as jmt
from bigdl_tpu.dataset import sample as jsample
from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.dataset import transformer as jtransformer
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.dataset import (DataSet, LocalDataSet, PaddingParam,
                                     Sample, SampleToMiniBatch,
                                     StreamingIngest, datasets, image,
                                     mt_batch, seqfile, text)
from bigdl_tpu_torch.dataset.device_augment import (color_jitter,
                                                    crop_flip_transpose)
from bigdl_tpu_torch.dataset.ingest import IngestInfraError, _Ring
from bigdl_tpu_torch.engine import BatchPrefetcher, DispatchPipeline
from bigdl_tpu_torch.optim import SGD, Optimizer, max_iteration
from bigdl_tpu_torch.utils import chaos
from bigdl_tpu_torch.utils import config as pconfig
from bigdl_tpu_torch.utils.convert import (params_from_jax, params_to_jax,
                                           state_to_jax)
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from test_torch_port_analysis import port_lock_witness  # noqa: F401

N_IMAGES, HW, BATCH, CROP = 24, (40, 48), 8, (32, 32)
SEED = 20240731


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
def properties(mods, **keys):
    """Config keys (dots as ``__``) set in ``mods`` and put back after."""
    saved = []
    for mod in mods:
        for key, value in keys.items():
            name = key.replace("__", ".")
            saved.append((mod, name, name in mod._OVERRIDES,
                          mod._OVERRIDES.get(name)))
            mod.set_property(name, value)
    try:
        yield
    finally:
        for mod, name, had, value in saved:
            if had:
                mod.set_property(name, value)
            else:
                mod.clear_property(name)


@pytest.fixture(scope="module")
def entries():
    """(name, label, JPEG bytes) of N_IMAGES smooth-blob-plus-noise
    images, as ``bench.py``'s ``_make_bench_seqfiles`` draws them."""
    from PIL import Image
    rng = np.random.RandomState(7)
    out = []
    for i in range(N_IMAGES):
        base = rng.normal(128, 40, size=HW + (3,))
        img = np.clip(base + rng.normal(0, 20, size=base.shape), 0,
                      255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        out.append((f"img_{i}.jpg", float(i % 5 + 1), buf.getvalue()))
    return out


@pytest.fixture(scope="module", autouse=True)
def _threads_before():
    """The threads alive when this module's first test starts.  Another
    test file that ran earlier in the same worker may leave its own
    threads behind: the JAX package's ``tests/test_ingest_faults.py``
    wedges a JAX ``ingest-reader`` thread in a one-hour upstream read on
    purpose.  The thread checks below hold this module's runs, so they
    leave those out."""
    return {t.ident for t in threading.enumerate()}


def _live(before, *prefixes):
    """Threads named with one of ``prefixes`` that were not alive before
    this module's first test."""
    return [t for t in threading.enumerate()
            if t.name.startswith(prefixes) and t.ident not in before]


def _records(entries, cls):
    return [cls(n, lab, data) for n, lab, data in entries]


def _same_state(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _inputs(batch):
    x = batch.get_input()
    return [np.asarray(a).copy() for a in x] if isinstance(x, list) \
        else [np.asarray(x).copy()]


def _first_batches(transformer, recs, generator_cls, n=3):
    """The first ``n`` batches of ``transformer`` over ``recs`` and the
    caller's generator state after them."""
    it = transformer(iter(recs))
    try:
        got = [next(it) for _ in range(n)]
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()
    return ([(_inputs(b), np.asarray(b.get_target()).copy()) for b in got],
            generator_cls.RNG().np.get_state())


# ------------------------------------------------------------ SequenceFiles

def test_sequence_files_read_the_same_in_both_packages(tmp_path, entries):
    paths = {"jax": str(tmp_path / "jax.seq"), "port": str(tmp_path / "p.seq"),
             "port_py": str(tmp_path / "py.seq")}
    jseq.write_image_seqfile(paths["jax"], entries)
    seqfile.write_image_seqfile(paths["port"], entries)
    seqfile.py_write_records(paths["port_py"], seqfile.image_records(entries))
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    want = [(n, lab, d) for n, lab, d in entries]
    for path in paths.values():
        assert list(seqfile.read_image_seqfile(path)) == want
        assert [seqfile.parse_image_record(k, v)
                for k, v in seqfile.py_read_records(path)] == want
        assert list(jseq.read_image_seqfile(path)) == want
        assert [(jseq._text_unframe(k).decode(), v) for k, v in
                jseq.py_read_records(path)] == \
            [(seqfile._text_unframe(k).decode(), v) for k, v in
             seqfile.py_read_records(path)]
    # a flipped byte in the first record's length field
    with open(paths["port"], "rb") as f:
        seqfile._read_header(f, paths["port"])
        first = f.tell()
    raw = bytearray(open(paths["port"], "rb").read())
    raw[first] ^= 0x40
    bad = tmp_path / "bad.seq"
    bad.write_bytes(bytes(raw))
    for read, error in (
            (lambda p: seqfile.read_image_seqfile(p),
             seqfile.CorruptRecordError),
            (lambda p: seqfile.py_read_records(p),
             seqfile.CorruptRecordError),
            (lambda p: jseq.py_read_records(p), jseq.CorruptRecordError)):
        with pytest.raises(error) as err:
            list(read(str(bad)))
        assert (err.value.offset, err.value.record_index) == (first, 0)
    skipped = []
    rest = list(seqfile.read_image_seqfile_resilient(
        str(bad), on_skip=lambda e, resume: skipped.append(resume)))
    assert len(skipped) == 1 and rest == want[len(want) - len(rest):]


def test_sharded_reader_and_seq_file_folder(tmp_path, entries):
    for fi in range(3):
        seqfile.write_image_seqfile(str(tmp_path / f"part-{fi}.seq"),
                                    entries[fi * 8:(fi + 1) * 8])
    ds = DataSet.seq_file_folder(str(tmp_path), shards=2, decode=False)
    assert [(r.name, r.label, r.bytes) for r in ds.records] == list(entries)
    jds = jingest.ShardedSeqFileReader(str(tmp_path), shards=3)
    assert [(r.name, r.label, r.bytes) for r in jds] == list(entries)
    decoded = list(DataSet.seq_file_folder(str(tmp_path)).data(train=False))
    jdecoded = list(jimage.BytesToBGRImg()(
        iter(_records(entries, jimage.LabeledImageBytes))))
    for a, b in zip(decoded, jdecoded, strict=True):
        np.testing.assert_array_equal(a.data, b.data)
        assert a.label == b.label


# ------------------------------------------------------------ the assembler

def test_assemblers_match_jax():
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((40, 48), (32, 33), (50, 40), (36, 36))]
    offs = np.array([[rng.randint(0, im.shape[0] - 31),
                      rng.randint(0, im.shape[1] - 31)] for im in imgs],
                    np.int32)
    flips = np.array([1, 0, 1, 1], np.uint8)
    mean, std = (104.0, 117.0, 123.0), (58.4, 57.1, 57.4)
    for mod_p, mod_j in ((mt_batch, jmt),):
        np.testing.assert_array_equal(
            mod_p.assemble_batch(imgs, CROP, offs, flips, mean, std, 3),
            mod_j.assemble_batch(imgs, CROP, offs, flips, mean, std, 3))
        np.testing.assert_array_equal(
            mod_p.assemble_batch_u8(imgs, CROP, offs, flips, 2),
            mod_j.assemble_batch_u8(imgs, CROP, offs, flips, 2))
        np.testing.assert_array_equal(
            mod_p.crop_flip_host(imgs, CROP, offs, flips),
            mod_j.crop_flip_host(imgs, CROP, offs, flips))
        with pytest.raises(ValueError, match="smaller than"):
            mod_p.assemble_batch_u8(imgs, (34, 34), offs, flips)


# ----------------------------------------------------- MT and the engine

MODES = {"host": {}, "device_normalize": {"device_normalize": True},
         "device_augment": {"device_augment": True}}
RINGS = [(1, 1, 1), (64, 16, 4)]    # record ring, decode window, batch ring


@pytest.fixture(scope="module")
def jax_batches(entries):
    """Per mode, the JAX package's first three batches and generator
    state: its MTLabeledBGRImgToBatch, and its StreamingIngest at its
    default rings (its own tests hold it across ring depths)."""
    out = {}
    for mode, kw in MODES.items():
        mt_kw = {"device_normalize": True} if kw else {}
        recs = _records(entries, jimage.LabeledImageBytes)
        with seeded(SEED):
            mt = _first_batches(jmt.MTLabeledBGRImgToBatch(
                BATCH, crop=CROP, **mt_kw), recs, JaxRandomGenerator)
        with seeded(SEED):
            eng = _first_batches(jingest.StreamingIngest(
                BATCH, crop=CROP, decode_workers=2, autoscale=False, **kw),
                recs, JaxRandomGenerator)
        out[mode] = mt, eng
    return out


@pytest.mark.parametrize("rings", RINGS, ids=["rings1", "rings64"])
@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_mt_and_streaming_ingest_match_jax(entries, jax_batches, mode,
                                           workers, rings):
    kw = MODES[mode]
    rec_d, dec_d, bat_d = rings
    mt_kw = {"device_normalize": True} if kw else {}
    runs = {"jax": jax_batches[mode][1]}
    with seeded(SEED):
        runs["port_mt"] = _first_batches(
            mt_batch.MTLabeledBGRImgToBatch(BATCH, crop=CROP,
                                            n_threads=workers, **mt_kw),
            _records(entries, image.LabeledImageBytes), RandomGenerator)
    with seeded(SEED):
        runs["port"] = _first_batches(
            StreamingIngest(BATCH, crop=CROP, decode_workers=workers,
                            record_ring_depth=rec_d,
                            decoded_ring_depth=dec_d,
                            batch_ring_depth=bat_d, **kw),
            _records(entries, image.LabeledImageBytes), RandomGenerator)
    ref_batches, ref_state = jax_batches[mode][0]
    for name in ("port_mt", "jax", "port"):
        batches, state = runs[name]
        _same_state(state, ref_state)
        for (xs, y), (ref_x, ref_y) in zip(batches, ref_batches,
                                           strict=True):
            np.testing.assert_array_equal(y, ref_y)
            if mode == "device_augment" and name in ("jax", "port"):
                frames, offs, flips = xs
                assert frames.shape == (BATCH,) + HW + (3,)
                xs = [crop_flip_transpose(
                    *(torch.from_numpy(a) for a in xs), *CROP).numpy()]
                np.testing.assert_array_equal(xs[0], np.asarray(
                    jaug.crop_flip_transpose(frames, offs, flips, *CROP)))
            assert len(xs) == 1
            np.testing.assert_array_equal(xs[0], ref_x[0], err_msg=name)


def test_streaming_ingest_under_thread_stress(entries, jax_batches,
                                              _threads_before):
    """More decode workers than cores and a short switch interval: the
    batches, the generator state and the stage counters stay exact."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with seeded(SEED):
            eng = StreamingIngest(BATCH, crop=CROP, decode_workers=24,
                                  record_ring_depth=2, decoded_ring_depth=9,
                                  assemble_threads=5)
            got = _first_batches(eng, _records(
                entries, image.LabeledImageBytes), RandomGenerator)
    finally:
        sys.setswitchinterval(interval)
    ref_batches, ref_state = jax_batches["host"][0]
    _same_state(got[1], ref_state)
    for (xs, y), (ref_x, ref_y) in zip(got[0], ref_batches, strict=True):
        np.testing.assert_array_equal(xs[0], ref_x[0])
        np.testing.assert_array_equal(y, ref_y)
    stats = eng.stats()
    assert stats["assemble"]["items"] == N_IMAGES
    assert stats["consume"]["items"] == N_IMAGES // BATCH
    assert not _live(_threads_before, "ingest-")


def test_a_close_never_returns_with_a_thread_alive(entries, monkeypatch,
                                                   _threads_before):
    """A decode held past the close (it waits on an event) keeps its
    ``ingest-decode`` thread alive: the close raises IngestInfraError
    naming it once ``JOIN_TIMEOUT_S`` has passed, rather than return with
    the thread running; the held assembler wakes on ``stop`` and ends."""
    from bigdl_tpu_torch.dataset import ingest
    started, release = threading.Event(), threading.Event()
    decode = mt_batch.MTLabeledBGRImgToBatch._decode
    calls = {"n": 0}

    def held_decode(data):
        calls["n"] += 1
        if calls["n"] == 3:          # the first record of the second batch
            started.set()
            release.wait(10.0)
        return decode(data)

    monkeypatch.setattr(ingest, "JOIN_TIMEOUT_S", 0.2, raising=False)
    monkeypatch.setattr(mt_batch.MTLabeledBGRImgToBatch, "_decode",
                        staticmethod(held_decode))
    with seeded(SEED):
        it = StreamingIngest(2, crop=CROP, decode_workers=1)(
            iter(_records(entries, image.LabeledImageBytes)))
        next(it)
        assert started.wait(5.0)
        try:
            with pytest.raises(IngestInfraError, match="ingest-decode-1"):
                it.close()
        finally:
            release.set()
    for t in _live(_threads_before, "ingest-"):
        t.join(5.0)
    assert not _live(_threads_before, "ingest-")


def test_streaming_ingest_refuses_what_is_not_ported(entries):
    """What the engine once refused (restarts, stall detection, the
    autoscaler, the fallback, the epoch cache, ``device_jitter``, the
    ingest chaos keys, ColorJitter) now builds and runs: every record comes
    through, and the jitter seeds ride along as a fourth input."""
    recs = _records(entries, image.LabeledImageBytes)
    for kw in ({"device_jitter": True, "device_augment": True},
               {"max_stage_restarts": 1}, {"stall_timeout": 5.0},
               {"autoscale": True}, {"fallback_on_failure": True},
               {"epoch_cache": True}):
        with seeded(SEED):
            got = list(StreamingIngest(BATCH, crop=CROP, decode_workers=2,
                                       **kw)(iter(recs)))
        assert sum(b.size() for b in got) == N_IMAGES, kw
        if "device_jitter" in kw:
            assert [len(b.get_input()) for b in got] == [4] * len(got)
    with properties([pconfig], bigdl__chaos__failDecodeAt="3"):
        chaos.install()
        try:
            eng = StreamingIngest(BATCH, crop=CROP, decode_workers=2,
                                  max_bad_records=1)
            with seeded(SEED):
                assert sum(b.size() for b in eng(iter(recs))) == \
                    N_IMAGES - 1
        finally:
            chaos.uninstall()
    assert eng.quarantine.by_stage == {"decode": 1}
    imgs = torch.zeros((2, 3, 4, 4), dtype=torch.uint8)
    seeds = torch.tensor([1, -1], dtype=torch.int32)
    assert color_jitter(imgs, seeds, brightness=0.4).shape == imgs.shape
    head = pnn.DeviceAugment(32, 32, color_jitter={"brightness": 0.4})
    assert head.color_jitter == {"brightness": 0.4}


def test_a_silently_dead_stage_raises_at_the_consumer(entries, monkeypatch):
    real_put = _Ring.put

    def put(ring, item, stop):
        if threading.current_thread().name == "ingest-reader":
            raise MemoryError("the reader dies")
        return real_put(ring, item, stop)

    monkeypatch.setattr(_Ring, "put", put)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    eng = StreamingIngest(BATCH, crop=CROP, decode_workers=1)
    before = threading.active_count()
    with seeded(SEED):
        with pytest.raises(IngestInfraError, match="'reader'"):
            list(eng(iter(_records(entries, image.LabeledImageBytes))))
    assert threading.active_count() == before


def test_undecodable_record_is_a_data_error(entries):
    recs = _records(entries, image.LabeledImageBytes)
    recs[3] = image.LabeledImageBytes("junk", 1.0, b"not a jpeg")
    with seeded(SEED):
        with pytest.raises(Exception, match="undecodable"):
            list(StreamingIngest(BATCH, crop=CROP, decode_workers=2)(
                iter(recs)))
        eng = StreamingIngest(BATCH, crop=CROP, decode_workers=2,
                              max_bad_records=1)
        got = list(eng(iter(recs)))
    assert sum(b.size() for b in got) == N_IMAGES - 1
    assert eng.run_history[-1]["quarantine"]["count"] == 1
    assert set(eng.stats()) == {"read", "decode", "assemble", "consume"}
    assert set(eng.stats()["decode"]) == {
        "items", "throughput_per_sec", "busy_s", "starve_s",
        "backpressure_s", "stall_frac", "mean_queue_depth"}


# ------------------------------------------------------ the device head

# ------------------------------------------- samples, loaders, text

# ----------------------------------------------------- the prefetcher

@pytest.fixture
def _prefetch_threads(_threads_before):
    return lambda: _live(_threads_before, "prefetch-")


def _epoch_fetch(n_records=20, batch=4):
    """A training-style fetch over a LocalDataSet with its on_batch
    rollover (a reshuffle from the thread's generator)."""
    ds = LocalDataSet([Sample(np.float32([i]), np.float32(1))
                       for i in range(n_records)]).transform(
        SampleToMiniBatch(batch))
    it = {"data": None}
    fetched = {"records": 0}

    def reset_epoch():
        ds.shuffle()
        it["data"] = ds.data(train=True)

    def fetch():
        b = next(it["data"])
        return b.get_input(), b.get_target(), b.size()

    def on_batch(b):
        fetched["records"] += b[2]
        if fetched["records"] >= n_records:
            fetched["records"] = 0
            reset_epoch()

    reset_epoch()
    return fetch, on_batch


# ----------------------------------------- training over the engine

def _conv_bn(mod, **kw):
    return (mod.Sequential()
            .add(mod.DeviceAugment(*CROP))
            .add(mod.ChannelNormalize((104.0, 117.0, 123.0),
                                      (58.0, 57.0, 57.0)))
            .add(mod.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **kw))
            .add(mod.SpatialBatchNormalization(4, **kw))
            .add(mod.ReLU())
            .add(mod.Reshape((4 * 32 * 32,)))
            .add(mod.Linear(4 * 32 * 32, 5, **kw))
            .add(mod.LogSoftMax()))


@pytest.fixture(scope="module")
def conv_bn_jax(entries):
    """The JAX package's conv + BN model, trained 5 iterations (an epoch
    of 3 and a reshuffle) over its device-augment StreamingIngest; its
    initial and trained parameters and trained state."""
    jm = _conv_bn(jnn)
    jm.reset(jax.random.PRNGKey(3))
    init = jax.tree_util.tree_map(np.asarray, jm.params)
    ds = JaxLocalDataSet(_records(entries, jimage.LabeledImageBytes))
    ds = ds.transform(jingest.StreamingIngest(
        BATCH, crop=CROP, device_augment=True, decode_workers=2,
        autoscale=False))
    opt = joptim.Optimizer.create(jm, ds, jnn.ClassNLLCriterion())
    opt.set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
    opt.set_end_when(joptim.max_iteration(5))
    with seeded(SEED):
        opt.optimize()
    return (init, jax.tree_util.tree_map(np.asarray, jm.params),
            jax.tree_util.tree_map(np.asarray, jm.state))


def _train_port(entries, init, depth, device_augment):
    model = pnn.to_channels_last(params_from_jax(init, _conv_bn(
        pnn, device="cpu")))
    eng = (StreamingIngest(BATCH, crop=CROP, device_augment=True,
                           decode_workers=2) if device_augment else
           StreamingIngest(BATCH, crop=CROP, device_normalize=True,
                           decode_workers=3, batch_ring_depth=1))
    ds = LocalDataSet(_records(entries, image.LabeledImageBytes)).transform(
        eng)
    opt = Optimizer.create(model, ds, pnn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(0.05, momentum=0.9))
    opt.set_end_when(max_iteration(5))
    with seeded(SEED), properties([pconfig], bigdl__prefetch__depth=depth):
        opt.optimize()
    assert [h["epoch"] for h in opt.history] == [1, 1, 1, 2, 2]
    return params_to_jax(model), state_to_jax(model)
