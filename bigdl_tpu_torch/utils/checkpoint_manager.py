"""Verified, committed, garbage-collected training snapshots
(``bigdl_tpu/utils/checkpoint_manager.py``; reference
``optim/DistriOptimizer.scala:394-416`` writes ``model.N`` /
``optimMethod.N``, :750-816 restores them).

A snapshot is a unit that restore takes only once it is proven whole:

- each payload's CRC (zlib's CRC32, written as the manifest's ``algo``;
  a manifest with ``algo`` CRC32C, as the JAX package writes where a
  native CRC32C is installed, is read too), byte count and
  semantic fingerprint (:func:`~bigdl_tpu_torch.integrity.host_fingerprint`
  over the payload before serialization) go into ``manifest.N``
  (``MANIFEST_VERSION`` 3, with the saving ``topology``);
- ``commit.N``, the manifest's CRC32C, is written last: its presence is
  the "snapshot is whole" bit;
- restore scans newest to oldest and takes the first snapshot that is
  committed and verifies, and falls back to the next-older one when a
  payload fails to load, so one torn write never bricks recovery;
- ``keep_last`` removes older snapshots, the commit marker first;
- with ``async_write`` the caller's thread only captures (device-to-host
  copies and ``torch.save`` into bytes, which must finish before the
  training loop moves the state on); checksums and file writes run on a
  writer thread, one write in flight, its error re-raised at the next
  save and at :meth:`CheckpointManager.join`, drained at exit.

The payloads are the port's own, written with ``torch.save`` and read
with ``torch.load(weights_only=True)``: ``model.N`` is the model's
``state_dict()`` (parameters and BatchNorm statistics) on the CPU,
``optimMethod.N`` the method as plain data
(:func:`~bigdl_tpu_torch.optim.optim_method.optim_payload`: its ``state``
and full-size slots).  The file names, the manifest's keys and the commit
marker are the JAX package's.  A pair without a manifest (a legacy
snapshot) is a candidate when both files exist; its loader is its only
check.

A full disk (``file_io.write_bytes`` raising
:class:`~bigdl_tpu_torch.resources.errors.StorageExhaustedError`) never
fails the run, as in the JAX package (:340-420): the snapshots beyond
``keep_last`` go oldest first (at least the newest stays) and the save is
tried once more (``Resources/emergency_gc``); when the disk still refuses,
checkpoints degrade to one snapshot kept as bytes in host memory
(``Resources/memory_snapshots``, ``Resources/storage_degraded``), which a
restore takes while it is newer than every committed one on disk.

Telemetry: the spans ``checkpoint/capture`` (the caller's thread, the
training loop's) and ``checkpoint/write`` (the writer thread, named
``bigdl-ckpt-writer``, or the caller's in synchronous mode).

Chaos (JAX :155-170): the capture passes each payload, after its semantic
fingerprint, through ``chaos.corrupt_state_before_save``
(``bigdl.chaos.corruptStateBeforeSaveAt``), and every payload write goes
through :func:`~bigdl_tpu_torch.utils.file_io.write_bytes`, where the
storage injectors act (``failWriteAt``, ``truncateWriteAt``,
``transientWrites``, ``diskFullAt``; :mod:`~bigdl_tpu_torch.utils.chaos`).

Not ported: ``watch_latest`` and remote stores
(:mod:`bigdl_tpu_torch.utils.file_io` is local only).
"""

from __future__ import annotations

import atexit
import json
import logging
import threading
import time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Tuple

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.integrity import fingerprint_key, host_fingerprint
from bigdl_tpu_torch.resources.errors import StorageExhaustedError
from bigdl_tpu_torch.utils import chaos, config, elastic, file_io
from bigdl_tpu_torch.visualization.crc32c import crc32c

logger = logging.getLogger("bigdl_tpu_torch")

#: 2 added ``topology``, 3 a ``fingerprint`` per file (the JAX package's)
MANIFEST_VERSION = 3


def payload_checksum(data: bytes) -> Tuple[str, int]:
    """(algo, value): zlib's CRC32 (the CRC32C table walk in Python runs at
    about 2 MB/s, too slow for a payload)."""
    return "crc32", zlib.crc32(data) & 0xFFFFFFFF


def checksum_by_algo(algo: str, data: bytes) -> int:
    """A payload checksum under the manifest's algorithm."""
    if algo == "crc32c":
        return crc32c(data)
    if algo == "crc32":
        return zlib.crc32(data) & 0xFFFFFFFF
    raise SnapshotCorruptError(f"unknown manifest checksum algo {algo!r}")


class SnapshotWriteError(RuntimeError):
    """A snapshot write (possibly a deferred, asynchronous one) failed."""


class SnapshotCorruptError(RuntimeError):
    """A snapshot payload failed its manifest's checksum or fingerprint."""


class SnapshotSchemaError(RuntimeError):
    """A manifest declares a schema newer than this reader."""

    def __init__(self, neval: int, found: Any):
        self.neval = neval
        self.found = found
        super().__init__(
            f"snapshot {neval}: manifest schema version {found!r} is newer "
            f"than this release understands (<= {MANIFEST_VERSION}): "
            "restore it with the release that wrote it")


def model_payload(model) -> Dict[str, Any]:
    """The model's ``state_dict()`` with every tensor on the CPU."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _capture(model, optim, neval: int
             ) -> Tuple[Dict[str, bytes], Dict[str, str]]:
    """Serialize the live model and method into detached bytes on the
    caller's thread; returns ``(blobs, fingerprints)``.  The training loop
    writes the parameters and slots in place after this returns, so the
    copy to the host and the serialization cannot move to the writer."""
    from bigdl_tpu_torch.optim.optim_method import optim_payload
    with telemetry.span("checkpoint/capture", neval=neval):
        blobs: Dict[str, bytes] = {}
        fps: Dict[str, str] = {}
        for name, payload in ((f"model.{neval}", model_payload(model)),
                              (f"optimMethod.{neval}",
                               optim_payload(optim))):
            fps[name] = fingerprint_key(host_fingerprint(payload))
            if chaos.active():
                # in-RAM rot between the fingerprint and the write: the
                # checksums are taken over the corrupt bytes and verify
                payload = chaos.corrupt_state_before_save(payload)
            blobs[name] = file_io.dumps(payload)
        return blobs, fps


class _AsyncWriter:
    """One background write in flight: :meth:`submit` joins the previous
    one first, so its error surfaces at the next save and at most one
    captured snapshot waits in memory."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None   # guarded by _lock

    def submit(self, job) -> None:
        self.join()

        def run():
            try:
                job()
            except BaseException as e:  # noqa: BLE001 - re-raised at join
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="bigdl-ckpt-writer")
        self._thread.start()

    def wait(self) -> None:
        """Wait for the write in flight to end; its error stays for
        :meth:`join`."""
        t = self._thread
        if t is not None:
            t.join()

    def join(self, raise_errors: bool = True,
             timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                logger.warning("checkpoint writer still running after "
                               "%.1fs: abandoning the wait", timeout)
                return
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            if raise_errors:
                raise SnapshotWriteError(
                    "background checkpoint write failed") from err
            logger.warning("background checkpoint write failed: %r", err)


#: managers with a write submitted, drained once more at exit
_LIVE_ASYNC_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()
_EXIT_HOOK_INSTALLED = [False]


def drain_all_async_writers(timeout: float = 30.0) -> None:
    """Join every live asynchronous writer (errors logged), so a snapshot
    submitted just before exit reaches its commit marker; bounded by
    ``timeout`` seconds each."""
    for mgr in list(_LIVE_ASYNC_MANAGERS):
        try:
            mgr.join(raise_errors=False, timeout=timeout)
        except Exception as e:  # pragma: no cover - shutdown
            logger.warning("checkpoint writer drain at exit failed: %r", e)


def _register_for_exit_drain(manager: "CheckpointManager") -> None:
    _LIVE_ASYNC_MANAGERS.add(manager)
    if not _EXIT_HOOK_INSTALLED[0]:
        _EXIT_HOOK_INSTALLED[0] = True
        atexit.register(drain_all_async_writers)


def _numbered(prefix: str, names) -> set:
    out = set()
    for f in names:
        if f.startswith(prefix) and ".tmp_bigdl" not in f:
            try:
                out.add(int(f[len(prefix):]))
            except ValueError:
                pass
    return out


class CheckpointManager:
    """The snapshots of one local checkpoint directory."""

    #: seconds a ``.tmp_bigdl`` temporary must sit untouched before the
    #: sweep removes it: a younger one may be another writer's
    TEMP_SWEEP_AGE_S = 3600.0

    def __init__(self, path: str, keep_last: Optional[int] = None,
                 async_write: Optional[bool] = None,
                 overwrite: bool = True):
        file_io.listdir(path)    # a remote scheme raises here
        self.path = path
        self.overwrite = overwrite
        self.keep_last = (keep_last if keep_last is not None
                          else config.get_int("bigdl.checkpoint.keepLast", 0))
        self.async_write = (async_write if async_write is not None else
                            config.get_bool("bigdl.checkpoint.asyncWrite",
                                            False))
        self._writer = _AsyncWriter() if self.async_write else None
        #: manifest of the snapshot :meth:`load_latest` last restored
        self.last_loaded_manifest: Optional[Dict[str, Any]] = None
        #: "same" or "reshard" for that restore; None before one
        self.last_restore_mode: Optional[str] = None
        #: seconds of the last save on the caller's thread (the capture,
        #: and in synchronous mode the write) and of the last write
        self.last_save_seconds: Optional[float] = None
        self.last_write_seconds: Optional[float] = None
        #: bytes of the last snapshot's two payloads
        self.last_snapshot_bytes: Optional[int] = None
        #: guards the two below; a full disk degrades to one snapshot, the
        #: newest, kept in memory
        self._state_lock = threading.Lock()
        self._storage_degraded = False
        self._memory_snapshot: Optional[Dict[str, Any]] = None

    # ---- save -------------------------------------------------------------

    def save(self, model, optim, neval: int,
             topology: Optional[Dict[str, Any]] = None) -> None:
        """Write snapshot ``neval``.  Synchronous mode returns once the
        commit marker has landed; asynchronous mode once the snapshot is
        captured (and a still running earlier write has ended, whose error
        re-raises here)."""
        t0 = time.perf_counter()
        if self._writer is not None:
            self._writer.join()
        blobs, fps = _capture(model, optim, neval)
        self.last_snapshot_bytes = sum(len(b) for b in blobs.values())
        if self._writer is not None:
            _register_for_exit_drain(self)
            self._writer.submit(
                lambda: self._write_snapshot(blobs, neval, topology, fps))
        else:
            self._write_snapshot(blobs, neval, topology, fps)
        self.last_save_seconds = time.perf_counter() - t0

    def _write_snapshot(self, blobs: Dict[str, bytes], neval: int,
                        topology: Optional[Dict[str, Any]],
                        fps: Dict[str, str]) -> None:
        t0 = time.perf_counter()
        with telemetry.span("checkpoint/write", neval=neval):
            self._write_or_degrade(blobs, neval, topology, fps)
        self.last_write_seconds = time.perf_counter() - t0

    def _write_or_degrade(self, blobs: Dict[str, bytes], neval: int,
                          topology: Optional[Dict[str, Any]],
                          fps: Dict[str, str]) -> None:
        """Write the snapshot's files; on a full disk free space oldest
        first and try once more, then degrade to the in-memory snapshot
        (JAX :336-372)."""
        if self._storage_degraded:
            self._keep_memory_snapshot(blobs, neval, topology, fps)
            return
        try:
            self._write_snapshot_files(blobs, neval, topology, fps)
            return
        except StorageExhaustedError as e:
            err = e
        if self._emergency_gc():
            try:
                self._write_snapshot_files(blobs, neval, topology, fps)
                logger.warning(
                    "checkpoint storage exhausted at snapshot %d: an "
                    "emergency oldest-first GC freed space and the save "
                    "landed", neval)
                return
            except StorageExhaustedError as e2:
                err = e2
        with self._state_lock:
            self._storage_degraded = True
        from bigdl_tpu_torch.resources import storage
        storage.note_degraded("checkpoints", err)
        self._keep_memory_snapshot(blobs, neval, topology, fps)

    def _keep_memory_snapshot(self, blobs: Dict[str, bytes], neval: int,
                              topology: Optional[Dict[str, Any]],
                              fps: Dict[str, str]) -> None:
        """Degraded mode: the newest snapshot as bytes in host memory (one,
        already captured)."""
        with self._state_lock:
            self._memory_snapshot = {"blobs": blobs, "neval": int(neval),
                                     "topology": topology, "fps": dict(fps)}
        telemetry.counter(
            "Resources/memory_snapshots",
            help="snapshots retained in RAM only (disk full)").inc()

    def _emergency_gc(self) -> bool:
        """Remove the snapshots beyond ``keep_last`` (at least the newest
        stays), oldest first and commit marker first, whatever the
        retention setting: run only on a full disk.  True when anything
        went."""
        keep = max(1, self.keep_last)
        removed = False
        for n, has_manifest in reversed(self.candidates()[keep:]):
            names = ((f"commit.{n}", f"model.{n}", f"optimMethod.{n}",
                      f"manifest.{n}") if has_manifest else
                     (f"model.{n}", f"optimMethod.{n}"))
            for name in names:
                try:
                    file_io.remove(file_io.join(self.path, name))
                    removed = True
                except OSError as e:
                    logger.warning("emergency checkpoint GC could not "
                                   "remove %s: %r", name, e)
        if removed:
            telemetry.counter(
                "Resources/emergency_gc",
                help="emergency oldest-first checkpoint GCs on storage "
                     "exhaustion").inc()
        return removed

    def _write_snapshot_files(self, blobs: Dict[str, bytes], neval: int,
                              topology: Optional[Dict[str, Any]],
                              fps: Dict[str, str]) -> None:
        file_io.makedirs(self.path)
        self._sweep_orphan_temps()
        algo = None
        files = {}
        for name, data in blobs.items():
            algo, value = payload_checksum(data)
            files[name] = {"checksum": value, "bytes": len(data),
                           "fingerprint": fps[name]}
        manifest = {"version": MANIFEST_VERSION, "neval": int(neval),
                    "algo": algo, "files": files}
        if topology is not None:
            manifest[elastic.TOPOLOGY_KEY] = topology
        for name, data in blobs.items():
            file_io.write_bytes(file_io.join(self.path, name), data,
                                self.overwrite)
        mbytes = json.dumps(manifest, sort_keys=True).encode("utf-8")
        file_io.write_bytes(file_io.join(self.path, f"manifest.{neval}"),
                            mbytes, self.overwrite)
        # last: the commit marker, the manifest's own CRC32C
        file_io.write_bytes(file_io.join(self.path, f"commit.{neval}"),
                            f"{crc32c(mbytes):08x}\n".encode("ascii"),
                            self.overwrite)
        self.gc()

    def _sweep_orphan_temps(self) -> None:
        now = time.time()
        for f in file_io.listdir(self.path):
            if ".tmp_bigdl" in f:
                full = file_io.join(self.path, f)
                mtime = file_io.modified_time(full)
                if mtime is None or now - mtime < self.TEMP_SWEEP_AGE_S:
                    continue
                try:
                    file_io.remove(full)
                except OSError:
                    pass

    # ---- scan and verify --------------------------------------------------

    def candidates(self) -> List[Tuple[int, bool]]:
        """``(neval, has_manifest)`` of every snapshot eligible for
        restore, newest first: both payloads exist, and a manifest-era
        snapshot has both its manifest and its commit marker (one without
        the other is a torn write, skipped)."""
        names = file_io.listdir(self.path)
        models = _numbered("model.", names)
        optims = _numbered("optimMethod.", names)
        manifests = _numbered("manifest.", names)
        commits = _numbered("commit.", names)
        out: List[Tuple[int, bool]] = []
        for n in sorted(models & optims, reverse=True):
            if n in commits and n in manifests:
                out.append((n, True))
            elif n not in commits and n not in manifests:
                out.append((n, False))   # a legacy pair
        return out

    def _read_manifest(self, n: int) -> Dict[str, Any]:
        data = file_io.read_bytes(file_io.join(self.path, f"manifest.{n}"))
        commit = file_io.read_bytes(
            file_io.join(self.path, f"commit.{n}")).strip()
        if commit != f"{crc32c(data):08x}".encode("ascii"):
            raise SnapshotCorruptError(f"snapshot {n}: commit marker does "
                                       "not match the manifest's checksum")
        manifest = json.loads(data.decode("utf-8"))
        version = manifest.get("version", 1)
        if not isinstance(version, int) or version > MANIFEST_VERSION:
            raise SnapshotSchemaError(n, version)
        return manifest

    def _read_verified(self, name: str,
                       manifest: Optional[Dict[str, Any]]) -> bytes:
        data = file_io.read_bytes(file_io.join(self.path, name))
        if manifest is not None:
            meta = manifest["files"][name]
            algo = manifest.get("algo", "crc32c")
            if (len(data) != meta["bytes"] or
                    checksum_by_algo(algo, data) != meta["checksum"]):
                raise SnapshotCorruptError(
                    f"{name}: payload fails its manifest {algo} checksum "
                    f"({len(data)} bytes)")
        return data

    @staticmethod
    def _check_fingerprint(name: str, payload: Any,
                           manifest: Optional[Dict[str, Any]]) -> None:
        """Recompute the payload's fingerprint and compare it with the
        save-time one: a mismatch behind a good checksum means the state
        was corrupt in memory before it was serialized."""
        if manifest is None:
            return
        expected = manifest["files"].get(name, {}).get("fingerprint")
        if expected is None:
            return
        got = fingerprint_key(host_fingerprint(payload))
        if got != expected:
            raise SnapshotCorruptError(
                f"{name}: state fingerprint {got} does not match the "
                f"save-time {expected}: the state was corrupt before "
                "serialization")

    def _load_payload(self, name: str, manifest: Optional[Dict[str, Any]]):
        payload = file_io.loads(self._read_verified(name, manifest))
        self._check_fingerprint(name, payload, manifest)
        return payload

    def verify(self, n: int, has_manifest: bool, deep: bool = False) -> bool:
        """Snapshot ``n`` matches its manifest: the commit marker and each
        payload's size, and with ``deep`` each payload's checksum and
        fingerprint.  A legacy pair passes.  A newer schema raises
        :class:`SnapshotSchemaError`; any other failure is logged and
        returns False."""
        if not has_manifest:
            return True
        try:
            manifest = self._read_manifest(n)
            for name in (f"model.{n}", f"optimMethod.{n}"):
                if deep:
                    self._load_payload(name, manifest)
                    continue
                sz = file_io.size(file_io.join(self.path, name))
                if sz != manifest["files"][name]["bytes"]:
                    raise SnapshotCorruptError(
                        f"{name}: size {sz} does not match the manifest "
                        f"({manifest['files'][name]['bytes']} bytes)")
            return True
        except SnapshotSchemaError:
            raise
        except Exception as e:
            logger.warning("snapshot %d fails verification (%s): skipping "
                           "to an older snapshot", n, e)
            return False

    def latest_valid(self) -> Optional[Tuple[str, str, int]]:
        """``(model_path, optimMethod_path, neval)`` of the newest snapshot
        that is committed and passes the shallow check, or None."""
        for n, has_manifest in self.candidates():
            if self.verify(n, has_manifest):
                return (file_io.join(self.path, f"model.{n}"),
                        file_io.join(self.path, f"optimMethod.{n}"), n)
        return None

    def load_latest(self, expected_topology: Optional[Dict[str, Any]] = None
                    ) -> Optional[Tuple[Any, Any, int]]:
        """``(model_payload, optim_payload, neval)`` of the newest snapshot
        that verifies and loads, walking to older ones past failures; None
        when there is none.  A changed topology reshards or raises
        :class:`~bigdl_tpu_torch.utils.elastic.TopologyMismatchError`;
        that and :class:`SnapshotSchemaError` propagate.  After the disk
        filled, the in-memory snapshot comes first while it is newer than
        every committed one."""
        mem = self._restore_memory_snapshot(expected_topology)
        if mem is not None:
            return mem
        for n, has_manifest in self.candidates():
            try:
                manifest = self._read_manifest(n) if has_manifest else None
                mode = "same"
                if expected_topology is not None and manifest is not None:
                    mode = elastic.check_restore_topology(
                        manifest.get(elastic.TOPOLOGY_KEY),
                        expected_topology)
                model = self._load_payload(f"model.{n}", manifest)
                optim = self._load_payload(f"optimMethod.{n}", manifest)
                self.last_loaded_manifest = manifest
                self.last_restore_mode = mode
                return model, optim, n
            except (SnapshotSchemaError, elastic.TopologyMismatchError):
                raise
            except Exception as e:
                logger.warning("snapshot %d failed to restore (%s: %s): "
                               "falling back to the next-older snapshot", n,
                               type(e).__name__, e)
        return None

    def _restore_memory_snapshot(
            self, expected_topology: Optional[Dict[str, Any]] = None
            ) -> Optional[Tuple[Any, Any, int]]:
        """The degraded mode's candidate, fingerprint-checked like a disk
        snapshot; None when there is none, when a disk snapshot is as new,
        or when it fails to load (the disk walk follows)."""
        with self._state_lock:
            mem = self._memory_snapshot
        if mem is None:
            return None
        disk = self.candidates()
        n = mem["neval"]
        if disk and disk[0][0] >= n:
            return None
        try:
            mode = "same"
            if expected_topology is not None and mem.get("topology"):
                mode = elastic.check_restore_topology(mem["topology"],
                                                      expected_topology)
            manifest = {"files": {name: {"fingerprint": fp}
                                  for name, fp in mem["fps"].items()}}
            payloads = []
            for name in (f"model.{n}", f"optimMethod.{n}"):
                payload = file_io.loads(mem["blobs"][name])
                self._check_fingerprint(name, payload, manifest)
                payloads.append(payload)
        except (SnapshotSchemaError, elastic.TopologyMismatchError):
            raise
        except Exception as e:
            logger.warning("in-memory snapshot %d failed to restore (%s: "
                           "%s): falling back to the disk", n,
                           type(e).__name__, e)
            return None
        self.last_loaded_manifest = None
        self.last_restore_mode = mode
        logger.warning("restoring snapshot %d from memory (checkpoint "
                       "storage is degraded: disk full)", n)
        return payloads[0], payloads[1], n

    # ---- retention ----------------------------------------------------------

    def gc(self) -> None:
        """Keep the newest ``keep_last`` snapshots that verify (legacy
        pairs included); remove the rest, and torn debris older than the
        newest kept one.  The commit marker goes first and the manifest
        last, so an interrupted GC leaves an uncommitted snapshot, never a
        committed half one or a bare pair taken for a legacy one."""
        if not self.keep_last or self.keep_last <= 0:
            return

        def rm(name: str) -> None:
            try:
                file_io.remove(file_io.join(self.path, name))
            except OSError as e:
                logger.warning("checkpoint GC could not remove %s: %r",
                               name, e)

        cands = self.candidates()
        if not cands:
            return
        keepers: List[int] = []
        drop: List[Tuple[int, bool]] = []
        protected: set = set()
        for n, has_manifest in cands:
            if len(keepers) >= self.keep_last:
                drop.append((n, has_manifest))
                continue
            try:
                ok = self.verify(n, has_manifest)
            except SnapshotSchemaError:
                protected.add(n)     # a newer release's: not debris
                continue
            if ok:
                keepers.append(n)
        for n, has_manifest in drop:
            if has_manifest:
                try:
                    self._read_manifest(n)
                except SnapshotSchemaError:
                    protected.add(n)
                    continue
                except Exception:
                    pass
            names = ((f"commit.{n}", f"model.{n}", f"optimMethod.{n}",
                      f"manifest.{n}") if has_manifest else
                     (f"model.{n}", f"optimMethod.{n}"))
            for name in names:
                rm(name)
        if not keepers:
            return
        newest, kept = keepers[0], set(keepers)
        for f in file_io.listdir(self.path):
            if ".tmp_bigdl" in f:
                continue
            prefix, _, tail = f.partition(".")
            if prefix not in ("model", "optimMethod", "manifest", "commit"):
                continue
            try:
                n = int(tail)
            except ValueError:
                continue
            if n < newest and n not in kept and n not in protected:
                rm(f)

    # ---- the writer ----------------------------------------------------

    def join(self, raise_errors: bool = True,
             timeout: Optional[float] = None) -> None:
        """Wait for the background writer (a no-op in synchronous mode);
        its deferred error re-raises here unless ``raise_errors`` is
        False."""
        if self._writer is not None:
            self._writer.join(raise_errors=raise_errors, timeout=timeout)

    def wait(self) -> None:
        """Wait for the background write in flight, leaving its error for
        :meth:`join` (a no-op in synchronous mode)."""
        if self._writer is not None:
            self._writer.wait()


def load_file(path: str) -> Any:
    """One payload file (a driver's ``--model`` or ``--state``), verified
    against its snapshot's manifest (checksum and fingerprint) when its
    directory holds that snapshot committed; a failure raises
    :class:`SnapshotCorruptError`.  A file outside a committed snapshot is
    read as it is."""
    import os
    name = os.path.basename(path)
    _, _, tail = name.partition(".")
    mgr = CheckpointManager(os.path.dirname(path) or ".", keep_last=0,
                            async_write=False)
    manifest = None
    if tail.isdigit() and (int(tail), True) in mgr.candidates():
        manifest = mgr._read_manifest(int(tail))
    return mgr._load_payload(name, manifest)
