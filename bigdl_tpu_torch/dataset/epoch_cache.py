"""Decoded-epoch cache: JPEG decode paid once across repeated epochs
(``bigdl_tpu/dataset/epoch_cache.py``).

Epochs 2..N decode the same compressed records that epoch 1 decoded.
:class:`DecodedEpochCache` sits at the decode stage
(``StreamingIngest``'s ``timed_decode``): a hit returns the decoded uint8
HWC frame without decoding, so a cached epoch is bounded by the assembler
and the copy to the card instead of the decoders.  The crop and flip draws
happen after the cache, on the assembler, record by record, so a cached
epoch's augmentation is bit-identical to a decoded one.

A segmented ring, newest kept:

- records append to an OPEN segment, which seals at ``segment_records``
  entries.  Sealed segments stay in host RAM or, with ``cache_dir`` set,
  are written to disk and leave RAM.
- the disk leg goes through :func:`bigdl_tpu_torch.utils.file_io.
  write_bytes` (atomic, with the chaos storage hooks).  A failed spill (a
  full disk, a dead mount) keeps the segment in RAM and stops spilling;
  the run goes on.
- a sealed blob is a ``<I`` header length, a JSON header (keys, shapes,
  dtypes and the CRC32 of the payload) and the frames' bytes, the JAX
  package's layout byte for byte.  A blob that fails its CRC, or cannot be
  parsed or read, on read (bit rot, truncation, a deleted file) is
  QUARANTINED: its index entries go, and those records decode from their
  bytes as if never cached.  It never crashes the run.
- the bytes are accounted to the host-memory governor (account
  ``ingest_epoch_cache:<name>``); a registered shrinker evicts the oldest
  RAM segments under pressure, and ``budget_mb`` (or half the governor's
  budget when 0) caps growth: when full, the oldest segment is evicted to
  admit the new one.

Thread safety: decode workers call :meth:`~DecodedEpochCache.get` and
:meth:`~DecodedEpochCache.put` concurrently; one lock serializes the index
and segments.  A disk read parses a whole segment and keeps the last one
parsed, which stream-order reads hit in turn.
"""

from __future__ import annotations

import json
import logging
import struct
import weakref
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.analysis.lockwitness import make_lock
from bigdl_tpu_torch.resources.governor import GOVERNOR as _governor
from bigdl_tpu_torch.utils import file_io

logger = logging.getLogger("bigdl_tpu_torch")

_HEADER_LEN = struct.Struct("<I")


def _serialize_segment(keys: List[str], arrays: List[np.ndarray]) -> bytes:
    payload = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    header = json.dumps({
        "keys": keys,
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [str(a.dtype) for a in arrays],
        "crc": zlib.crc32(payload) & 0xFFFFFFFF,
    }).encode("utf-8")
    return _HEADER_LEN.pack(len(header)) + header + payload


def _deserialize_segment(blob: bytes) -> Tuple[List[str], List[np.ndarray]]:
    """Parse + CRC-verify a sealed segment blob; raises ``ValueError``
    on any corruption (truncation, bit flips, junk headers) so the
    caller can quarantine instead of crash."""
    try:
        (hlen,) = _HEADER_LEN.unpack_from(blob, 0)
        header = json.loads(blob[4:4 + hlen].decode("utf-8"))
        payload = blob[4 + hlen:]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != header["crc"]:
            raise ValueError("payload CRC mismatch")
        arrays, off = [], 0
        for shape, dtype in zip(header["shapes"], header["dtypes"]):
            a = np.frombuffer(payload, np.dtype(dtype),
                              count=int(np.prod(shape)) if shape else 1,
                              offset=off).reshape(shape)
            off += a.nbytes
            arrays.append(a)
        if off != len(payload):
            raise ValueError("payload length mismatch")
        return header["keys"], arrays
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"unparseable cache segment: {e!r}") from e


class DecodedEpochCache:
    """Keyed decoded-frame store (key = record name).  See module doc."""

    def __init__(self, name: str, cache_dir: Optional[str] = None,
                 budget_mb: int = 0, segment_records: int = 256):
        self.name = name
        self.cache_dir = cache_dir
        self.budget_bytes = max(0, int(budget_mb)) * (1 << 20)
        self.segment_records = max(1, int(segment_records))
        self._lock = make_lock("epoch_cache")
        #: key -> (segment_id, slot); dropped entries mean "not cached"
        self._index: Dict[str, Tuple[int, int]] = {}
        #: sealed RAM segments + the open one, oldest-first insertion
        self._ram: Dict[int, Tuple[List[str], List[np.ndarray]]] = {}
        #: sealed disk segments: id -> path
        self._disk: Dict[int, str] = {}
        self._open_keys: List[str] = []
        self._open_arrays: List[np.ndarray] = []
        self._open_bytes = 0
        self._seg_seq = 0
        self._ram_bytes = 0
        self._disk_ok = cache_dir is not None
        self._parsed: Optional[Tuple[int, Dict[str, int],
                                     List[np.ndarray]]] = None
        self.hits = 0
        self.misses = 0
        self.corrupt_segments = 0
        self.evicted_segments = 0
        self._acct = _governor.account(f"ingest_epoch_cache:{name}")
        self._shrink_key = f"epoch_cache:{name}:{id(self)}"
        # weak self-reference: the governor's shrinker registry must not
        # pin the cache (and every frame it holds) past its engine
        ref = weakref.ref(self)

        def _shrink_hook() -> None:
            cache = ref()
            if cache is not None:
                cache.shrink()

        _governor.register_shrinker(self._shrink_key, _shrink_hook)

    # -- capacity ---------------------------------------------------------

    def _cap(self) -> int:
        """Byte cap: the explicit budget, else half the governor's whole
        host budget (the cache must never be the reason training
        buffers cannot breathe), else unbounded-by-cap (the governor's
        pressure shrinker is still live)."""
        if self.budget_bytes:
            return self.budget_bytes
        gb = _governor.budget_bytes()
        return max(1, gb // 2) if gb > 0 else (1 << 62)

    def _evict_oldest_ram(self) -> bool:
        """Drop the oldest sealed RAM segment (ring semantics)."""
        if not self._ram:
            return False
        seg_id = next(iter(self._ram))
        keys, arrays = self._ram.pop(seg_id)
        n = sum(a.nbytes for a in arrays)
        self._ram_bytes -= n
        self._acct.sub(n)
        for k in keys:
            self._index.pop(k, None)
        self.evicted_segments += 1
        return True

    def shrink(self) -> None:
        """Governor pressure hook: evict half the sealed RAM segments,
        oldest first — Resources/host_bytes drops on the next poll."""
        with self._lock:
            for _ in range(max(1, len(self._ram) // 2)):
                if not self._evict_oldest_ram():
                    break

    def close(self) -> None:
        _governor.unregister_shrinker(self._shrink_key)
        with self._lock:
            while self._evict_oldest_ram():
                pass
            if self._open_bytes:
                self._acct.sub(self._open_bytes)
            self._open_keys, self._open_arrays = [], []
            self._open_bytes = 0
            self._index.clear()
            self._disk.clear()
            self._parsed = None

    # -- write path -------------------------------------------------------

    def put(self, key: Optional[str], img: np.ndarray) -> None:
        """Admit one decoded frame.  No-ops on unnamed records, on
        already-cached keys (a second epoch's redundant decode — the
        resubmit path after a dead worker), and when the ring cannot
        make room."""
        if key is None:
            return
        n = int(img.nbytes)
        with self._lock:
            if key in self._index:
                return
            cap = self._cap()
            while (self._ram_bytes + self._open_bytes + n > cap and
                   self._evict_oldest_ram()):
                pass
            if self._ram_bytes + self._open_bytes + n > cap:
                return          # one open segment already fills the cap
            seg_id = self._seg_seq
            self._index[key] = (seg_id, len(self._open_keys))
            self._open_keys.append(key)
            self._open_arrays.append(img)
            self._open_bytes += n
            self._acct.add(n)
            if len(self._open_keys) >= self.segment_records:
                self._seal()

    def _seal(self) -> None:
        """Seal the open segment (lock held).  Disk when armed — via the
        write_bytes choke point, degrading to RAM on failure."""
        seg_id = self._seg_seq
        self._seg_seq += 1
        keys, arrays = self._open_keys, self._open_arrays
        nbytes = self._open_bytes
        self._open_keys, self._open_arrays = [], []
        self._open_bytes = 0
        if self._disk_ok:
            path = f"{self.cache_dir.rstrip('/')}/" \
                   f"{self.name}_seg{seg_id:06d}.bin"
            try:
                file_io.write_bytes(path, _serialize_segment(keys, arrays))
                self._disk[seg_id] = path
                self._acct.sub(nbytes)     # RAM released, disk holds it
                return
            except BaseException as e:
                # disk-full / dead mount: DEGRADE to RAM-only, keep the
                # already-decoded work, never crash the run
                self._disk_ok = False
                telemetry.counter(
                    "Ingest/epoch_cache_spill_failures", summary=True,
                    help="epoch-cache disk spills abandoned (cache "
                         "degraded to RAM-only)").inc()
                logger.warning(
                    "epoch cache '%s' disk spill failed (%r) — "
                    "degrading to RAM-only", self.name, e)
        self._ram[seg_id] = (keys, arrays)
        self._ram_bytes += nbytes

    # -- read path --------------------------------------------------------

    def _quarantine(self, seg_id: int, path: str, err: Exception) -> None:
        """Corrupt disk segment: drop its index entries so every record
        it held re-decodes from source bytes (lock held)."""
        self._disk.pop(seg_id, None)
        dropped = [k for k, (s, _i) in self._index.items() if s == seg_id]
        for k in dropped:
            del self._index[k]
        self.corrupt_segments += 1
        telemetry.counter(
            "Ingest/epoch_cache_corrupt_segments", summary=True,
            help="checksum-failed epoch-cache segments quarantined "
                 "(records re-decode from source)").inc()
        logger.warning(
            "epoch cache '%s' segment %s failed verification (%s) — "
            "quarantined, %d records will re-decode", self.name, path,
            err, len(dropped))

    def get(self, key: Optional[str]) -> Optional[np.ndarray]:
        """Decoded frame for ``key``, or None (miss / evicted /
        quarantined) — the caller decodes from bytes on None."""
        if key is None:
            return None
        with self._lock:
            loc = self._index.get(key)
            if loc is None:
                self.misses += 1
                return None
            seg_id, slot = loc
            if seg_id == self._seg_seq:            # still open
                self.hits += 1
                return self._open_arrays[slot]
            if seg_id in self._ram:
                self.hits += 1
                return self._ram[seg_id][1][slot]
            path = self._disk.get(seg_id)
            if path is None:                        # evicted meanwhile
                del self._index[key]
                self.misses += 1
                return None
            if self._parsed is not None and self._parsed[0] == seg_id:
                _sid, bykey, arrays = self._parsed
                idx = bykey.get(key)
                if idx is not None:
                    self.hits += 1
                    return arrays[idx]
            try:
                blob = file_io.read_bytes(path)
                keys, arrays = _deserialize_segment(blob)
            except (ValueError, OSError) as e:
                self._quarantine(seg_id, path, e)
                self.misses += 1
                return None
            self._parsed = (seg_id, {k: i for i, k in enumerate(keys)},
                            arrays)
            idx = self._parsed[1].get(key)
            if idx is None:                         # header/key drift
                self._quarantine(seg_id, path,
                                 ValueError("key missing from segment"))
                self.misses += 1
                return None
            self.hits += 1
            return arrays[idx]

    # -- diagnostics ------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits, "misses": self.misses,
                "ram_segments": len(self._ram),
                "disk_segments": len(self._disk),
                "open_records": len(self._open_keys),
                "ram_bytes": self._ram_bytes + self._open_bytes,
                "corrupt_segments": self.corrupt_segments,
                "evicted_segments": self.evicted_segments,
                "disk_ok": self._disk_ok,
            }
