"""The decoded-epoch cache, the threefry PRNG, ColorJitter and the jitter
seeds of the ingest engine, held against the JAX package on the CPU (the
twins of ``tests/test_epoch_cache.py`` and of
``tests/test_prefetch_determinism.py``'s
``test_device_jitter_seeds_depth_invariant``).

* ``DecodedEpochCache``: its RAM and disk legs, the quarantine of a
  bit-flipped, truncated or deleted segment, the governor's account and
  shrinker; a sealed segment's blob is byte for byte the JAX cache's for
  the same frames; cached epochs through ``StreamingIngest`` are
  bit-identical to the JAX engine's and to the synchronous path's, a
  quarantined segment included.
* ``utils/prng.py``: ``prng_key``, ``split`` and ``uniform`` give the bits
  of jax 0.9.0's ``PRNGKey``, ``split`` and ``uniform`` (threefry2x32, the
  partitionable scheme) for hypothesis-drawn int32 seeds, negative ones
  and the extremes among them.
* ``color_jitter``: the brightness and saturation legs are exact; with the
  contrast leg (an image mean, summed in another order than XLA's) every
  pixel is within 1 of the JAX function's and at most 0.1% of them
  differ (3.05e-5 measured: 6 of 196608 pixels at these seeds).

The governor is process-wide: every test here resets the port's before and
after, and puts back the config keys it sets.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import device_augment as jaug
from bigdl_tpu.dataset import epoch_cache as jcache
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import ingest as jingest
from bigdl_tpu.utils import config as jconfig
import bigdl_tpu_torch.nn as pnn
from bigdl_tpu_torch.dataset import epoch_cache, image, ingest, mt_batch
from bigdl_tpu_torch.dataset.device_augment import color_jitter
from bigdl_tpu_torch.dataset.epoch_cache import DecodedEpochCache
from bigdl_tpu_torch.resources import GOVERNOR
from bigdl_tpu_torch.utils import chaos, config, prng
from test_torch_port_analysis import port_lock_witness  # noqa: F401
from test_torch_port_ingest import seeded
from test_torch_port_ingest_faults import png_entries

CROP = (32, 32)
_KEYS = ("bigdl.ingest.epochCache", "bigdl.ingest.epochCacheDir",
         "bigdl.ingest.epochCacheBudgetMB",
         "bigdl.ingest.epochCacheSegmentRecords",
         "bigdl.resources.hostMemBudgetMB", "bigdl.chaos.hostMemPressureAt")


@pytest.fixture(autouse=True)
def _clean_env():
    GOVERNOR.reset()
    yield
    chaos.uninstall()
    GOVERNOR.reset()
    for mod in (jconfig, config):
        for k in _KEYS:
            mod.clear_property(k)


def _frames(n, seed=0, hw=(8, 6)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=hw + (3,)).astype(np.uint8)
            for _ in range(n)]


# ------------------------------------------------------ the segment ring

def test_ram_roundtrip_bit_exact():
    cache = DecodedEpochCache("t", segment_records=4)
    frames = _frames(10)
    for i, f in enumerate(frames):
        cache.put(f"r{i}", f)
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(cache.get(f"r{i}"), f)
    s = cache.stats()
    assert s["hits"] == 10 and s["ram_segments"] == 2
    assert s["open_records"] == 2
    cache.close()


def test_unknown_and_unnamed_keys_are_misses():
    cache = DecodedEpochCache("t")
    assert cache.get("nope") is None
    cache.put(None, _frames(1)[0])
    assert cache.stats()["open_records"] == 0
    assert cache.stats()["misses"] == 1
    cache.close()


def test_disk_spill_readback_and_blobs_byte_identical_to_jax(tmp_path):
    """Sealed segments go to disk and leave RAM; each blob is the JAX
    cache's byte for byte (the ``<I`` header length, the JSON header with
    the CRC32, the frames)."""
    frames = _frames(8, seed=1)
    caches = {}
    for name, mod in (("port", epoch_cache), ("jax", jcache)):
        d = tmp_path / name
        caches[name] = mod.DecodedEpochCache("t", cache_dir=str(d),
                                             segment_records=4)
        for i, f in enumerate(frames):
            caches[name].put(f"r{i}", f)
    s = caches["port"].stats()
    assert s["disk_segments"] == 2 and s["ram_segments"] == 0
    assert s["ram_bytes"] == 0
    blobs = {name: sorted((p.name, p.read_bytes())
                          for p in (tmp_path / name).glob("*.bin"))
             for name in caches}
    assert len(blobs["port"]) == 2 and blobs["port"] == blobs["jax"]
    keys = [f"r{i}" for i in range(4)]
    assert epoch_cache._serialize_segment(keys, frames[:4]) == \
        jcache._serialize_segment(keys, frames[:4])
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(caches["port"].get(f"r{i}"), f)
    for cache in caches.values():
        cache.close()


def test_budget_cap_stops_admission_without_crashing():
    cache = DecodedEpochCache("t", budget_mb=0, segment_records=2)
    cache._cap = lambda: 1
    for i, f in enumerate(_frames(4)):
        cache.put(f"r{i}", f)
    assert cache.stats()["ram_bytes"] <= 1
    cache.close()


def test_budget_evicts_the_oldest_segment():
    """A cap of two segments' bytes: admitting a third evicts the
    oldest, whose records miss from then on."""
    frames = _frames(6)
    cache = DecodedEpochCache("t", segment_records=2)
    cache._cap = lambda: 4 * frames[0].nbytes
    for i, f in enumerate(frames):
        cache.put(f"r{i}", f)
    s = cache.stats()
    assert s["evicted_segments"] >= 1
    assert cache.get("r0") is None
    np.testing.assert_array_equal(cache.get("r5"), frames[5])
    cache.close()


# ------------------------------------------------------ corrupt segments

def _spilled(tmp_path, n=4):
    cache = DecodedEpochCache("t", cache_dir=str(tmp_path),
                              segment_records=n)
    frames = _frames(n, seed=2)
    for i, f in enumerate(frames):
        cache.put(f"r{i}", f)
    (path,) = list(tmp_path.glob("*.bin"))
    return cache, frames, path


def test_bitflipped_segment_quarantined_not_crash(tmp_path):
    cache, _, path = _spilled(tmp_path)
    blob = bytearray(path.read_bytes())
    blob[-3] ^= 0x40
    path.write_bytes(bytes(blob))
    assert cache.get("r0") is None
    assert cache.stats()["corrupt_segments"] == 1
    assert cache.get("r1") is None
    assert cache.stats()["corrupt_segments"] == 1
    fresh = _frames(1, seed=9)[0]
    for i in range(4):
        cache.put(f"s{i}", fresh)
    np.testing.assert_array_equal(cache.get("s0"), fresh)
    cache.close()


@pytest.mark.parametrize("damage", ["truncated", "deleted"])
def test_truncated_or_deleted_segment_quarantined(tmp_path, damage):
    cache, _, path = _spilled(tmp_path)
    if damage == "truncated":
        path.write_bytes(path.read_bytes()[:7])
    else:
        os.remove(path)
    assert cache.get("r2") is None
    assert cache.stats()["corrupt_segments"] == 1
    cache.close()


# ---------------------------------------------------------- the governor

def test_bytes_ride_a_named_account():
    cache = DecodedEpochCache("eng0", segment_records=2)
    for i, f in enumerate(_frames(4, seed=3)):
        cache.put(f"r{i}", f)
    key = "Resources/host_bytes_ingest_epoch_cache:eng0"
    assert dict(GOVERNOR.summary_scalars())[key] > 0
    cache.close()
    assert dict(GOVERNOR.summary_scalars())[key] == 0.0


def test_injected_pressure_shrinks_the_cache():
    cache = DecodedEpochCache("eng1", segment_records=2)
    for i, f in enumerate(_frames(8, seed=4)):
        cache.put(f"r{i}", f)
    before = cache.stats()["ram_bytes"]
    config.set_property("bigdl.chaos.hostMemPressureAt", 1)
    chaos.install()
    assert GOVERNOR.poll() is True
    after = cache.stats()
    assert after["ram_bytes"] < before and after["evicted_segments"] >= 1
    assert cache.get("r0") is None
    cache.close()


# --------------------------------------------------------- end to end

def _run(pkg, entries, seed, eng):
    cls = jimage.LabeledImageBytes if pkg == "jax" else \
        image.LabeledImageBytes
    with seeded(seed):
        return [(np.asarray(b.get_input()).copy(),
                 np.asarray(b.get_target()).copy())
                for b in eng(iter([cls(*e) for e in entries]))]


def _assert_same(a, b):
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("spill", [False, True], ids=["ram", "disk"])
def test_cached_epochs_bit_identical_and_hitting(tmp_path, spill):
    """Epoch 2 decodes nothing that epoch 1 decoded, and both epochs are
    the synchronous path's and the JAX engine's batches.  On disk, a
    segment bit-flipped between the epochs is quarantined and its records
    decode again from their bytes: the batches do not change."""
    entries = png_entries()
    sync = []
    for seed in (11, 12):
        with seeded(seed):
            sync.append([(b.get_input().copy(), b.get_target().copy())
                         for b in mt_batch.MTLabeledBGRImgToBatch(
                             4, crop=CROP)(iter(
                                 [image.LabeledImageBytes(*e)
                                  for e in entries]))])
    keys = {"bigdl.ingest.epochCache": True,
            "bigdl.ingest.epochCacheSegmentRecords": 4}
    engines = {}
    for pkg, mod, cfg in (("jax", jingest, jconfig),
                          ("port", ingest, config)):
        for k, v in keys.items():
            cfg.set_property(k, v)
        if spill:
            cfg.set_property("bigdl.ingest.epochCacheDir",
                             str(tmp_path / pkg))
        engines[pkg] = mod.StreamingIngest(4, crop=CROP, decode_workers=2)
    for pkg, eng in engines.items():
        assert eng.epoch_cache is not None
        _assert_same(_run(pkg, entries, 11, eng), sync[0])
        assert eng.epoch_cache.stats()["misses"] == len(entries)
        if spill:
            first = sorted((tmp_path / pkg).glob("*.bin"))[0]
            blob = bytearray(first.read_bytes())
            blob[-3] ^= 0x40
            first.write_bytes(bytes(blob))
        _assert_same(_run(pkg, entries, 12, eng), sync[1])
        s = eng.epoch_cache.stats()
        assert s["hits"] == (len(entries) - 4 if spill else len(entries))
        assert s["corrupt_segments"] == (1 if spill else 0)


# ------------------------------------------------------------ threefry

_INT32 = st.integers(-2 ** 31, 2 ** 31 - 1)
_EXTREMES = [0, 1, -1, 2 ** 31 - 1, -2 ** 31]


@jax.jit
def _jax_draws(seeds):
    keys = jax.vmap(jax.random.PRNGKey)(seeds)
    sub = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    uni = [jax.vmap(lambda k: jax.random.uniform(k, (), minval=lo,
                                                 maxval=hi))(sub[:, i])
           for i, (lo, hi) in enumerate(((0.6, 1.4), (0.0, 1.0),
                                         (0.999, 1.001)))]
    return keys, sub, uni


@settings(max_examples=25, deadline=None)
@given(st.lists(_INT32, min_size=59, max_size=59))
def test_threefry_bits_equal_jax(drawn):
    seeds = np.asarray(drawn + _EXTREMES, np.int32)
    jkeys, jsub, juni = _jax_draws(jnp.asarray(seeds))
    keys = prng.prng_key(torch.from_numpy(seeds))
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    sub = prng.split(keys, 3)
    np.testing.assert_array_equal(sub.numpy(),
                                  np.asarray(jsub).astype(np.int64))
    for i, (lo, hi) in enumerate(((0.6, 1.4), (0.0, 1.0), (0.999, 1.001))):
        got = prng.uniform(sub[:, i], lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(juni[i]).view(np.int32))


# ------------------------------------------------------------ ColorJitter

def test_color_jitter_within_one_of_jax():
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (64, 3, 32, 32)).astype(np.uint8)
    seeds = rng.randint(-2 ** 31, 2 ** 31 - 1, 64).astype(np.int32)
    for kw, exact in (({"brightness": 0.4}, True),
                      ({"saturation": 0.4}, True),
                      ({"contrast": 0.4}, False),
                      ({"brightness": 0.4, "contrast": 0.4,
                        "saturation": 0.4}, False)):
        want = np.asarray(jaug.color_jitter(jnp.asarray(imgs),
                                            jnp.asarray(seeds), **kw))
        got = color_jitter(torch.from_numpy(imgs), torch.from_numpy(seeds),
                           **kw).numpy()
        d = np.abs(want.astype(np.int32) - got.astype(np.int32))
        assert d.max() <= (0 if exact else 1), kw
        assert (d > 0).mean() <= 1e-3, kw


def test_device_augment_color_jitter_and_seeds_match_jax():
    """``StreamingIngest(device_jitter=True)`` packs the JAX engine's seeds
    at every ring depth, and ``DeviceAugment(color_jitter=...)`` over its
    batches is within 1 of the JAX head's."""
    entries = png_entries(12)
    kw = {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4}

    def seeds_at(mod, cls, workers, rec_d, dec_d, bat_d):
        eng = mod.StreamingIngest(4, crop=CROP, device_augment=True,
                                  device_jitter=True, decode_workers=workers,
                                  record_ring_depth=rec_d,
                                  decoded_ring_depth=dec_d,
                                  batch_ring_depth=bat_d)
        with seeded(20240731):
            return [[np.asarray(a).copy() for a in b.get_input()]
                    for b in eng(iter([cls(*e) for e in entries]))]

    port = seeds_at(ingest, image.LabeledImageBytes, 1, 1, 1, 1)
    deep = seeds_at(ingest, image.LabeledImageBytes, 3, 64, 16, 4)
    jax_b = seeds_at(jingest, jimage.LabeledImageBytes, 2, 256, 8, 2)
    assert [len(x) for x in port] == [4] * 3
    for a, b, c in zip(port, deep, jax_b):
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        assert a[3].dtype == np.int32
    head = pnn.DeviceAugment(*CROP, color_jitter=kw)
    jhead = jnn.DeviceAugment(*CROP, color_jitter=kw)
    for x in port:
        got = head([torch.from_numpy(a) for a in x]).numpy()
        want, _ = jhead.apply({}, [jnp.asarray(a) for a in x], {})
        d = np.abs(np.asarray(want).astype(np.int32) - got.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    # without the seeds the head crops and does not jitter, as JAX's does
    plain = head([torch.from_numpy(a) for a in port[0][:3]]).numpy()
    np.testing.assert_array_equal(plain, np.asarray(jhead.apply(
        {}, [jnp.asarray(a) for a in port[0][:3]], {})[0]))


def test_color_jitter_keeps_the_seeds_device_and_is_pure():
    imgs = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (4, 3, 8, 8)).astype(np.uint8))
    seeds = torch.tensor([5, -5, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32)
    a = color_jitter(imgs, seeds, brightness=0.4, contrast=0.2)
    b = color_jitter(imgs, seeds.to(torch.int64), brightness=0.4,
                     contrast=0.2)
    assert a.dtype == torch.uint8 and a.shape == imgs.shape
    assert torch.equal(a, b)
    assert torch.equal(color_jitter(imgs, seeds), imgs)
