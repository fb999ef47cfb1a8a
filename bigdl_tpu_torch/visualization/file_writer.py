"""TFRecord-framed event file writing (``bigdl_tpu/visualization/
file_writer.py``).

Reference equivalents: ``visualization/tensorboard/RecordWriter.scala:30-57``
(length + masked-CRC32C framing), ``EventWriter.scala`` (async queue draining
to an ``events.out.tfevents.<ts>.<host>`` file), ``FileWriter.scala:30``
(user-facing handle).  Files are readable by stock TensorBoard.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import time
from typing import Optional

from bigdl_tpu_torch.visualization.crc32c import masked_crc32c
from bigdl_tpu_torch.visualization import proto


def write_record(f, data: bytes) -> None:
    """One TFRecord frame: u64 length, u32 masked-crc(length), payload,
    u32 masked-crc(payload) (reference RecordWriter.scala:38-44)."""
    header = struct.pack("<Q", len(data))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc32c(data)))


def read_records(path: str):
    """Iterate raw event payloads from an events file, checking CRCs
    (readback support, reference TrainSummary.readScalar).  A short read
    anywhere mid-record means an in-progress append — treated as
    end-of-stream, not corruption."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc_raw = f.read(4)
            if len(hcrc_raw) < 4:
                return
            if struct.unpack("<I", hcrc_raw)[0] != masked_crc32c(header):
                raise IOError(f"corrupt record header in {path}")
            data = f.read(length)
            if len(data) < length:
                return
            dcrc_raw = f.read(4)
            if len(dcrc_raw) < 4:
                return
            if struct.unpack("<I", dcrc_raw)[0] != masked_crc32c(data):
                raise IOError(f"corrupt record payload in {path}")
            yield data


class EventWriter:
    """Background-thread writer draining an event queue to one events file
    (reference ``EventWriter.scala``: async append, periodic flush).
    :meth:`close` drains the queue and joins the thread."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        os.makedirs(log_dir, exist_ok=True)
        # the pid suffix (TF2's own convention) keeps two same-host
        # processes created in the same second from appending to one file
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._flush_secs = flush_secs
        self._error: Optional[Exception] = None
        # TensorBoard requires this version marker as the first event
        self.add_event(proto.encode_event(file_version="brain.Event:2"))
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="event-writer")
        self._thread.start()

    def add_event(self, event: bytes) -> None:
        self._q.put(event)

    def _run(self) -> None:
        last_flush = time.time()
        while True:
            try:
                ev = self._q.get(timeout=self._flush_secs)
            except queue.Empty:
                self._f.flush()
                last_flush = time.time()
                continue
            try:
                if ev is None:
                    self._f.flush()
                    return
                try:
                    write_record(self._f, ev)
                except Exception as e:  # keep draining so flush() can't hang
                    if self._error is None:
                        self._error = e
                        import logging
                        logging.getLogger("bigdl_tpu_torch").error(
                            "event write failed, dropping further summaries: "
                            "%s", e)
            finally:
                self._q.task_done()
            if time.time() - last_flush >= self._flush_secs:
                self._f.flush()
                last_flush = time.time()

    def flush(self) -> None:
        """Block until every queued event is on disk."""
        self._q.join()
        self._f.flush()

    def close(self) -> None:
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=10)
        self._f.close()


class FileWriter:
    """User-facing writer (reference ``FileWriter.scala:30``).

    The events file is created lazily on the first write: under
    multi-host training every process constructs the summary objects
    (the SPMD script runs everywhere) but only the writer process emits
    events (``optim.optimizer.is_writer_process``) — constructing a
    FileWriter must therefore not leave an empty events file behind on
    the N-1 silent processes."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._flush_secs = flush_secs
        self._writer: Optional[EventWriter] = None

    def _ensure_writer(self) -> EventWriter:
        if self._writer is None:
            self._writer = EventWriter(self.log_dir, self._flush_secs)
        return self._writer

    def add_summary(self, summary: bytes, global_step: int) -> "FileWriter":
        self._ensure_writer().add_event(
            proto.encode_event(step=global_step, summary=summary))
        return self

    def add_event(self, event: bytes) -> "FileWriter":
        self._ensure_writer().add_event(event)
        return self

    def flush(self) -> "FileWriter":
        if self._writer is not None:
            self._writer.flush()
        return self

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
