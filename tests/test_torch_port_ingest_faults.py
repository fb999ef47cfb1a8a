"""The ingest engine's data faults, read retries, SequenceFile resync and
the prefetcher's fault paths, held against the JAX package on the CPU
(the twins of ``tests/test_ingest_faults.py``'s quarantine, transient-read,
resync and prefetcher cases).

Records are 12 PNGs of 40 x 48 drawn with numpy from a seed, batches of 4,
crops of 32 x 32, both packages' generators seeded alike.  The same chaos
plan (``bigdl.chaos.*``) is installed in each package for its own run; the
batches are compared bit for bit between the two engines and against the
port's synchronous ``MTLabeledBGRImgToBatch`` over the surviving records.
One difference is by design: a read blip that outlasts
``bigdl.io.retryTimes`` raises ``IngestInfraError`` in the port (the blip
its cause) and the blip itself in the JAX package.

Every test puts back both packages' generators, the config keys it sets
and the chaos plans.  No port test file holds more than 25 tests
(ROADMAP.md, standing rules).
"""

import contextlib
import io
import struct
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import ingest as jingest
from bigdl_tpu.dataset import mt_batch as jmt
from bigdl_tpu.dataset import seqfile as jseq
from bigdl_tpu.utils import chaos as jchaos
from bigdl_tpu.utils import config as jconfig
from bigdl_tpu.utils.random_generator import \
    RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.dataset import image, ingest, mt_batch, seqfile
from bigdl_tpu_torch.engine import BatchPrefetcher, DispatchPipeline
from bigdl_tpu_torch.utils import chaos, config
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from test_torch_port_analysis import port_lock_witness  # noqa: F401
from test_torch_port_ingest import _live, _threads_before, seeded  # noqa: F401

CROP = (32, 32)


def png_entries(n=12, hw=(40, 48), seed=3):
    """(name, label, PNG bytes) of ``n`` random images, as the JAX
    package's fault tests draw them."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        img = rng.randint(0, 256, size=hw + (3,)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        out.append((f"r{i}", float(i % 5 + 1), buf.getvalue()))
    return out


@pytest.fixture(autouse=True)
def _fast_retries():
    """No real backoff sleeps; the chaos plans go after each test."""
    for mod in (jconfig, config):
        mod.set_property("bigdl.io.retryInterval", 0.001)
    yield
    for mod in (jconfig, config):
        mod.clear_property("bigdl.io.retryInterval")
    jchaos.uninstall()
    chaos.uninstall()


@contextlib.contextmanager
def plan(pkg, **keys):
    """A chaos plan of ``bigdl.chaos.<key>`` values installed in one
    package (``"jax"`` or ``"port"``) for the block."""
    cfg, ch = (jconfig, jchaos) if pkg == "jax" else (config, chaos)
    for k, v in keys.items():
        cfg.set_property(f"bigdl.chaos.{k}", v)
    try:
        ch.install()
    finally:
        for k in keys:
            cfg.clear_property(f"bigdl.chaos.{k}")
    try:
        yield
    finally:
        ch.uninstall()


def batches(transformer, records):
    return [(np.asarray(b.get_input()).copy(),
             np.asarray(b.get_target()).copy())
            for b in transformer(iter(records))]


def engine_run(pkg, entries, chaos_keys=None, seed=7, **kw):
    """Batches of one package's StreamingIngest (4, 32 x 32 crops, 2
    decode workers) over ``entries`` under a chaos plan, and the engine."""
    mod, cls = ((jingest, jimage.LabeledImageBytes) if pkg == "jax"
                else (ingest, image.LabeledImageBytes))
    recs = [cls(*e) for e in entries]
    kw.setdefault("decode_workers", 2)
    with seeded(seed), plan(pkg, **(chaos_keys or {})):
        eng = mod.StreamingIngest(4, crop=CROP, **kw)
        return batches(eng, recs), eng


def sync_batches(entries, seed=7):
    """The port's synchronous path over ``entries``."""
    with seeded(seed):
        return batches(mt_batch.MTLabeledBGRImgToBatch(4, crop=CROP),
                       [image.LabeledImageBytes(*e) for e in entries])


def assert_stream_equal(got, want):
    assert len(got) == len(want)
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


def both_match(entries, survivors, chaos_keys=None, **kw):
    """Both engines' batches under the plan, each equal to the port's
    synchronous path over ``survivors``; returns (jax engine, port
    engine)."""
    want = sync_batches(survivors)
    engines = []
    for pkg in ("jax", "port"):
        got, eng = engine_run(pkg, entries, chaos_keys, **kw)
        assert_stream_equal(got, want)
        engines.append(eng)
    return engines


# ------------------------------------------------------------- quarantine

def test_corrupt_record_skipped_and_stream_matches_survivors():
    e = png_entries()
    jeng, peng = both_match(e, e[:5] + e[6:], {"corruptRecordAt": "5"},
                            max_bad_records=3)
    for eng in (jeng, peng):
        assert eng.quarantine.count == 1
        sample = eng.quarantine.samples[0]
        assert sample["stage"] == "read" and sample["index"] == 5


def test_decode_failure_quarantined_before_any_draw():
    e = png_entries()
    jeng, peng = both_match(e, e[:3] + e[4:], {"failDecodeAt": "3"},
                            max_bad_records=3)
    assert peng.quarantine.by_stage == jeng.quarantine.by_stage == \
        {"decode": 1}


def test_genuinely_undecodable_bytes_quarantined():
    e = png_entries(10)
    e[5] = ("junk", 1.0, b"not an image at all")
    jeng, peng = both_match(e, e[:5] + e[6:], max_bad_records=1)
    assert peng.quarantine.count == jeng.quarantine.count == 1


def test_undersized_record_quarantined_with_budget():
    e = png_entries(6)
    e[2:3] = png_entries(1, hw=(20, 48))
    jeng, peng = both_match(e, e[:2] + e[3:], max_bad_records=1)
    assert peng.quarantine.by_stage == jeng.quarantine.by_stage == \
        {"assemble": 1}


def test_budget_zero_keeps_fail_fast_contract():
    """Budget 0 (the default) raises the original data error in both."""
    e = png_entries(8)
    with pytest.raises(jchaos.CorruptRecord):
        engine_run("jax", e, {"corruptRecordAt": "2"})
    with pytest.raises(chaos.CorruptRecord):
        engine_run("port", e, {"corruptRecordAt": "2"})


def test_budget_exceeded_fails_loudly_with_offender_sample():
    e = png_entries()
    for pkg, error in (("jax", jingest.QuarantineExceededError),
                       ("port", ingest.QuarantineExceededError)):
        recs = [image.LabeledImageBytes(*x) for x in e] if pkg == "port" \
            else [jimage.LabeledImageBytes(*x) for x in e]
        mod = ingest if pkg == "port" else jingest
        with plan(pkg, corruptRecordAt="2:8"):
            eng = mod.StreamingIngest(4, crop=CROP, decode_workers=2,
                                      max_bad_records=2)
            with pytest.raises(error, match="maxBadRecords"):
                list(eng(iter(recs)))
        assert len(eng.quarantine.samples) == 3
        assert eng.quarantine.samples[0]["index"] == 2


def test_quarantine_counts_flow_to_metrics_registry():
    counter = telemetry.counter("Ingest/quarantined", summary=True)
    before = counter.value
    _, eng = engine_run("port", png_entries(8), {"failDecodeAt": "1"},
                        max_bad_records=2)
    assert counter.value == before + 1
    assert eng.fault_stats()["quarantine"]["count"] == 1
    assert eng.fault_stats()["stage_restarts"] == 0


# ---------------------------------------------------------- transient reads

def test_transient_read_blips_retry_to_bit_parity():
    e = png_entries()
    jeng, peng = both_match(e, e, {"transientReads": 2}, max_bad_records=3)
    assert peng.quarantine.count == jeng.quarantine.count == 0


def test_blips_beyond_retry_budget_surface_as_infra_error():
    """Past ``bigdl.io.retryTimes`` the port raises IngestInfraError with
    the blip as its cause, the JAX package the blip itself; neither
    quarantines anything (a blip is not dirty data)."""
    e = png_entries(8)
    for mod in (jconfig, config):
        mod.set_property("bigdl.io.retryTimes", 2)
    try:
        with pytest.raises(jchaos.ChaosError, match="transient"):
            engine_run("jax", e, {"transientReads": 5}, max_bad_records=3)
        recs = [image.LabeledImageBytes(*x) for x in e]
        with plan("port", transientReads=5):
            eng = ingest.StreamingIngest(4, crop=CROP, decode_workers=2,
                                         max_bad_records=3)
            with pytest.raises(ingest.IngestInfraError,
                               match="retryTimes=2") as err:
                list(eng(iter(recs)))
        assert isinstance(err.value.__cause__, chaos.ChaosError)
        assert eng.quarantine.count == 0
    finally:
        for mod in (jconfig, config):
            mod.clear_property("bigdl.io.retryTimes")


# -------------------------------------------------------- seqfile resync

def _write(tmp_path, mod, n=10, payload=1100, name="a.seq"):
    path = str(tmp_path / name)
    entries = [(f"k{i}", float(i + 1), bytes([i % 256]) * payload)
               for i in range(n)]
    mod.write_image_seqfile(path, entries)
    return path, entries


def _record_offsets(path):
    offs = []
    with open(path, "rb") as f:
        seqfile._read_header(f, path)
        while True:
            o = f.tell()
            raw = f.read(4)
            if not raw:
                return offs
            (rl,) = struct.unpack(">i", raw)
            if rl == -1:
                f.read(16)
                continue
            offs.append(o)
            f.read(4 + rl)


def _break_length(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        f.write(b"\x7f\xff\xff\xff")


def test_corrupt_error_names_offset_and_record_index(tmp_path):
    path, _ = _write(tmp_path, seqfile)
    offs = _record_offsets(path)
    _break_length(path, offs[4])
    for read in (seqfile.read_image_seqfile, jseq.read_image_seqfile):
        with pytest.raises(IOError, match=rf"record 4 at offset {offs[4]}"):
            list(read(path))


def test_resync_skips_to_next_marker_not_the_whole_shard(tmp_path):
    path, _ = _write(tmp_path, seqfile)
    clean = list(seqfile.read_image_seqfile(path))
    offs = _record_offsets(path)
    _break_length(path, offs[4])
    runs = {}
    for name, mod in (("port", seqfile), ("jax", jseq)):
        skips = []
        got = list(mod.read_image_seqfile_resilient(
            path, on_skip=lambda e, resume: skips.append((e, resume))))
        runs[name] = (got, [(e.record_index, e.offset, r)
                            for e, r in skips])
    assert runs["port"] == runs["jax"]
    got, skips = runs["port"]
    assert len(skips) == 1
    index, offset, resume = skips[0]
    assert index == 4 and offset == offs[4]
    assert resume is not None and resume > offs[4]
    assert got[:4] == clean[:4]
    assert got[4:] == (clean[-len(got) + 4:] if len(got) > 4 else [])
    assert len(got) >= len(clean) - 3


def test_find_next_sync_none_past_last_marker(tmp_path):
    path, _ = _write(tmp_path, seqfile)
    size = (tmp_path / "a.seq").stat().st_size
    assert seqfile.find_next_sync(path, size - 4) is None
    for offset in (0, 100, 5000):
        assert seqfile.find_next_sync(path, offset) == \
            jseq.find_next_sync(path, offset)


def test_sharded_reader_quarantines_corrupt_records(tmp_path):
    good = [(f"k{i}", 1.0, bytes([i]) * 1100) for i in range(8)]
    seqfile.write_image_seqfile(str(tmp_path / "a.seq"), good)
    seqfile.write_image_seqfile(str(tmp_path / "b.seq"), good)
    path_b = str(tmp_path / "b.seq")
    _break_length(path_b, _record_offsets(path_b)[3])
    q = ingest.RecordQuarantine(budget=4)
    names = [r.name for r in ingest.ShardedSeqFileReader(
        str(tmp_path), shards=2, quarantine=q)]
    jq = jingest.RecordQuarantine(budget=4)
    jnames = [r.name for r in jingest.ShardedSeqFileReader(
        str(tmp_path), shards=2, quarantine=jq)]
    assert names == jnames and q.count == jq.count >= 1
    assert len(names) >= 8 + 5
    with pytest.raises(IOError):
        list(ingest.ShardedSeqFileReader(str(tmp_path), shards=2))


def test_sharded_reader_resumes_after_a_transient_blip(tmp_path,
                                                       monkeypatch):
    """A transient failure mid-file re-opens it and resumes after the
    records already given: the sweep equals a clean one, in both
    packages."""
    for fi in range(2):
        seqfile.write_image_seqfile(
            str(tmp_path / f"p{fi}.seq"),
            [(f"f{fi}k{i}", 1.0, bytes([i]) * 300) for i in range(6)])
    want = [r.name for r in ingest.ShardedSeqFileReader(str(tmp_path),
                                                        shards=2)]
    real = seqfile.read_image_seqfile
    calls = {"n": 0}

    def flaky(path):
        calls["n"] += 1
        for i, rec in enumerate(real(path)):
            if calls["n"] == 1 and i == 3:
                raise ConnectionError("blip")
            yield rec

    monkeypatch.setattr(seqfile, "read_image_seqfile", flaky)
    got = [r.name for r in ingest.ShardedSeqFileReader(str(tmp_path),
                                                       shards=1)]
    assert got == want and calls["n"] == 3


# ------------------------------------------- the prefetcher's fault paths

def _fetcher(fail_at):
    state = {"n": 0}

    def fetch():
        state["n"] += 1
        if state["n"] == fail_at:
            raise RuntimeError("fetch boom")
        return np.ones((5 * 256 * 1024,), np.float32)

    return fetch, state


def test_error_before_first_batch_raises_immediately():
    fetch, _ = _fetcher(fail_at=1)
    p = BatchPrefetcher(fetch, depth=2, transfer_ahead=2, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="fetch boom"):
            p()
    finally:
        p.stop()


def test_teardown_with_a_blocked_producer_does_not_deadlock():
    """Abandoned while the producer is blocked on full queues: stop joins
    both threads and invents no error."""
    fetch, _ = _fetcher(fail_at=10 ** 9)
    p = BatchPrefetcher(fetch, depth=2, transfer_ahead=3, device="cpu")
    p()
    time.sleep(0.3)                     # the queues fill, the producer waits
    t0 = time.monotonic()
    p.stop()
    assert time.monotonic() - t0 < 15
    assert not p._thread.is_alive()
    assert not p._transfer_thread.is_alive()
    assert p.error is None


def test_dispatch_pipeline_abandon_skips_drain():
    drained = []
    p = DispatchPipeline(lambda item, nxt: drained.append(item[0]), depth=8)
    for i in range(5):
        p.push(i)
    assert p.abandon() == 5
    p.flush()
    assert drained == []
    p.push(7)
    p.flush()
    assert drained == [7]


def test_zero_copy_upload_aliases_only_when_asked():
    """``bigdl.ingest.zeroCopyUpload``: both settings give the same bits;
    only the default (true) shares the assembler's buffer, and only for a
    C-contiguous array of 64 KiB or more; the prefetcher follows the key
    as it was when it was made."""
    from bigdl_tpu_torch.engine import ZERO_COPY_MIN_BYTES, to_device
    big = np.arange(ZERO_COPY_MIN_BYTES, dtype=np.uint8)
    small = np.arange(16, dtype=np.int32)
    out = {}
    for flag in (True, False):
        config.set_property("bigdl.ingest.zeroCopyUpload", flag)
        try:
            moved = [to_device(a, "cpu") for a in (big, small, big[::2])]
            p = BatchPrefetcher(lambda: [big, small], depth=2, device="cpu")
            try:
                staged = p()
            finally:
                p.stop()
        finally:
            config.clear_property("bigdl.ingest.zeroCopyUpload")
        out[flag] = moved, staged
        for t, a in zip(moved + staged, (big, small, big[::2], big, small)):
            np.testing.assert_array_equal(t.numpy(), a)
    shares = {flag: [np.shares_memory(t.numpy(), big)
                     for t in (moved[0], staged[0])]
              for flag, (moved, staged) in out.items()}
    assert shares == {True: [True, True], False: [False, False]}
    for flag, (moved, staged) in out.items():
        assert not np.shares_memory(moved[1].numpy(), small)
        assert not np.shares_memory(moved[2].numpy(), big)
    assert isinstance(out[True][0][0], torch.Tensor)


def test_mt_transformer_accepts_explicit_drawer():
    """The synchronous path's own drawer (the fallback's hook): an explicit
    generator replaces the thread's, in both packages alike."""
    e = png_entries(8)
    got = batches(mt_batch.MTLabeledBGRImgToBatch(
        4, crop=CROP, rng=RandomGenerator(99)),
        [image.LabeledImageBytes(*x) for x in e])
    ref = batches(jmt.MTLabeledBGRImgToBatch(
        4, crop=CROP, rng=JaxRandomGenerator(99)),
        [jimage.LabeledImageBytes(*x) for x in e])
    assert_stream_equal(got, ref)
    assert_stream_equal(batches(mt_batch.MTLabeledBGRImgToBatch(
        4, crop=CROP, rng=RandomGenerator(99)),
        [image.LabeledImageBytes(*x) for x in e]), got)


def test_no_thread_outlives_the_fault_runs(_threads_before):
    """Every engine above closed with its supervisor, stage and decode
    threads joined."""
    e = png_entries(8)
    engine_run("port", e, {"corruptRecordAt": "1"}, max_bad_records=1)
    assert not _live(_threads_before, "ingest-")
