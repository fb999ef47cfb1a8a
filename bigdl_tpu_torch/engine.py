"""Device policy, the host-to-device crossing, the batch prefetcher and the
topology of the port (``bigdl_tpu/engine.py``: ``DispatchPipeline`` :30,
``BatchPrefetcher`` :87-345, the ``Engine`` singleton :387-445,
``allgather_sum`` :508, and ``to_device``).

The JAX package discovers its devices through a process-wide singleton.  The
port holds no such state: every entry point takes ``device=``, which defaults
to ``"cuda"`` and is checked here.  Nothing switches to the CPU quietly; the
caller asks for it.

The topology is PyTorch's: one process per rank (the ``torchrun`` model),
joined into a ``torch.distributed`` process group by the one explicit call
:meth:`Engine.init_distributed` (NCCL for a CUDA rank, gloo for a CPU one).
Nothing joins a group at import or when a trainer is built.  A "node" of the
reference is a rank of the group and a "core" the one device a rank drives.
The JAX package's named device mesh (``Engine.create_mesh``, :467-498) is a
:class:`Mesh` here: the group's ranks laid out row-major over named axes,
with one subgroup per axis line.  :func:`bind_axes` is the twin of a
``shard_map`` binding its axes: inside it, :func:`bound_axis` gives the
subgroup of a named axis to the modules that split work over it (the
Megatron head split, the expert-parallel dispatch); outside it, those
modules run whole.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import threading
from collections import deque
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.utils import config
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.analysis.lockwitness import make_lock

DeviceLike = Union[str, torch.device]


def default_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on.  Raises :class:`RuntimeError`
    for a CUDA device when CUDA is not available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        if dev.index is None:   # tensors report "cuda:N", never "cuda"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


#: the zero-copy floor (JAX ``engine.py`` ``_ZERO_COPY_MIN_BYTES``): smaller
#: arrays (crop origins, flip flags, labels) gain nothing from aliasing
ZERO_COPY_MIN_BYTES = 1 << 16


def host_tensor(x: np.ndarray, zero_copy: Optional[bool] = None
                ) -> torch.Tensor:
    """A host array as a CPU tensor.  With ``bigdl.ingest.zeroCopyUpload``
    (default on; ``zero_copy`` overrides it) a C-contiguous array of
    :data:`ZERO_COPY_MIN_BYTES` or more is aliased, not copied: the JAX
    package's dlpack leg (``engine.py`` ``_leaf_to_device``), safe because
    the assembler packs a fresh buffer per batch and never writes it after
    the hand-off.  Any other array, and every array with the key off, is
    copied first, the JAX package's ``jnp.asarray`` leg."""
    if zero_copy is None:
        zero_copy = config.get_bool("bigdl.ingest.zeroCopyUpload", True)
    if (zero_copy and x.nbytes >= ZERO_COPY_MIN_BYTES and
            x.flags["C_CONTIGUOUS"]):
        return torch.from_numpy(x)
    return torch.from_numpy(np.array(x, order="C", copy=True))


def to_device(x: np.ndarray, device: DeviceLike) -> torch.Tensor:
    """Move a host array onto ``device``, keeping its dtype: the single
    host-to-device crossing point of the serving path (:func:`host_tensor`
    first)."""
    return host_tensor(x).to(device)


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested list/tuple/dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested list/tuple/dict, in :func:`tree_map`'s
    order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_to_device(tree, device: DeviceLike):
    """Every array leaf (numpy, or a host tensor) of ``tree`` moved onto
    ``device`` from pageable memory on the current stream; other leaves
    pass through."""
    def move(x):
        if isinstance(x, np.ndarray):
            return to_device(x, device)
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x
    return tree_map(move, tree)


def check_on_device(model: torch.nn.Module, device: torch.device) -> None:
    """Raise :class:`ValueError` unless every parameter and buffer of
    ``model`` lies on ``device`` (an entry point serves the model where the
    caller built it and never moves it behind the caller's back)."""
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        if t.device != device:
            raise ValueError(f"model tensor {name} is on {t.device}, not on "
                             f"{device}: build the model with "
                             f"device={str(device)!r} or move it there")


class Engine:
    """The topology half of the JAX package's ``Engine`` (reference
    ``utils/Engine.scala:313``), read from the default process group."""

    @staticmethod
    def init_distributed(backend: Optional[str] = None,
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         device: DeviceLike = "cuda") -> None:
        """Join the default process group, the port's only process-wide
        state change.  Without arguments it reads the ``torchrun``
        environment (``init_method="env://"``: ``MASTER_ADDR``,
        ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).  ``backend`` defaults
        to ``"nccl"`` for a CUDA ``device`` and ``"gloo"`` for the CPU; on
        CUDA the rank's device becomes ``LOCAL_RANK`` (else ``rank``
        modulo the visible cards).  No-op when the group exists."""
        if dist.is_initialized():
            return
        dev = default_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        kwargs = {}
        if rank is not None:
            kwargs["rank"] = rank
        if world_size is not None:
            kwargs["world_size"] = world_size
        if dev.type == "cuda":
            local = os.environ.get("LOCAL_RANK")
            if local is None:
                local = (rank if rank is not None
                         else int(os.environ.get("RANK", 0)))
                local %= torch.cuda.device_count()
            torch.cuda.set_device(int(local))
        dist.init_process_group(backend, init_method=init_method or "env://",
                                **kwargs)

    @staticmethod
    def create_mesh(mesh_shape=None, axis_names=None,
                    group: Optional[dist.ProcessGroup] = None) -> "Mesh":
        """The ranks of ``group`` (the default group; without one, this
        process alone) as a named mesh.  Default: every rank on a
        ``data`` axis.  ``prod(mesh_shape)`` must be the rank count.
        Collective: every rank of the group calls it, in the same order
        (it makes the axis subgroups)."""
        world = (dist.get_world_size(group)
                 if dist.is_available() and dist.is_initialized() else 1)
        if mesh_shape is None:
            mesh_shape = (world,)
            axis_names = axis_names or ("data",)
        mesh_shape = tuple(int(s) for s in mesh_shape)
        axis_names = tuple(axis_names or
                           MESH_AXES[:len(mesh_shape)])
        if len(axis_names) != len(mesh_shape):
            raise ValueError(f"{len(axis_names)} axis names for a mesh of "
                             f"{len(mesh_shape)} dims")
        if int(np.prod(mesh_shape)) != world:
            raise ValueError(f"mesh shape {mesh_shape} does not cover "
                             f"{world} devices")
        return Mesh(mesh_shape, axis_names, group)

    @staticmethod
    def node_number() -> int:
        """The ranks of the default group (1 without a group)."""
        return dist.get_world_size() if dist.is_initialized() else 1

    @staticmethod
    def core_number() -> int:
        """Devices a rank drives: one, in the one-process-per-rank model."""
        return 1


#: the JAX package's default axis names, in order (``Engine.MESH_AXES``)
MESH_AXES = ("data", "model", "seq")


class Mesh:
    """The ranks of a process group laid out row-major over named axes,
    as the JAX package lays its devices out (``np.reshape`` of the device
    list): rank ``r`` sits at ``np.unravel_index(r, shape)``, so on a
    ``("data", "model")`` mesh ``rank = d * n_model + m``, and a
    ``ShardedDataSet`` partition reaches the same coordinates in both
    packages.  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does.  :meth:`group` is this rank's
    subgroup along an axis: the ranks that share every other coordinate.
    Built by :meth:`Engine.create_mesh`."""

    def __init__(self, mesh_shape, axis_names, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, mesh_shape))
        self.size = int(np.prod(mesh_shape))
        self.parent = group
        on = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank(group) if on else 0
        self.coords = dict(zip(self.axis_names, (int(c) for c in
                               np.unravel_index(self.rank, mesh_shape))))
        self._groups = {}
        if not on:
            return
        ranks = np.arange(self.size).reshape(mesh_shape)
        if group is not None:
            ranks = np.vectorize(
                lambda r: dist.get_global_rank(group, int(r)))(ranks)
        for i, name in enumerate(self.axis_names):
            # every line along axis i, in one order on every rank: each
            # rank takes part in every new_group call
            lines = np.moveaxis(ranks, i, -1).reshape(-1, mesh_shape[i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if dist.get_rank() in line:
                    self._groups[name] = g

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """This rank's subgroup along ``axis`` (None without a process
        group)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no {axis!r} axis: {self.axis_names}")
        return self._groups.get(axis)

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


#: the axes :func:`bind_axes` binds, process-wide: autograd runs a CUDA
#: backward (and a rematerialised forward inside it) on a thread of its own
_BOUND = {"axes": {}}


@contextlib.contextmanager
def bind_axes(mesh: Mesh, axes):
    """For the block, the named ``axes`` of ``mesh`` are bound (the twin of
    a ``shard_map`` over them): :func:`bound_axis` returns their
    subgroups."""
    prev = _BOUND["axes"]
    _BOUND["axes"] = dict(prev, **{a: (mesh.group(a), mesh.shape[a],
                                       mesh.coord(a)) for a in axes})
    try:
        yield
    finally:
        _BOUND["axes"] = prev


def bound_axis(name: Optional[str]):
    """``(subgroup, size, coordinate)`` of the axis ``name`` while
    :func:`bind_axes` binds it, else None (the JAX package's
    ``_axis_bound``)."""
    if not name:
        return None
    return _BOUND["axes"].get(name)


def allgather_sum(rows, group: Optional[dist.ProcessGroup] = None
                  ) -> np.ndarray:
    """Sum a small per-rank float array over the group, in float64 (the
    identity without a group).  Collective: every rank calls it with an
    array of the same shape."""
    rows = np.asarray(rows, np.float64)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return rows
    on = ("cuda" if "nccl" in dist.get_backend(group) else "cpu")
    t = torch.from_numpy(rows.copy()).to(on)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.cpu().numpy()


class DispatchPipeline:
    """Bounded queue of in-flight device results whose copies to the host
    start when they are pushed (the JAX package's ``DispatchPipeline``,
    :30): keeping ``depth - 1`` results in flight means reading one does
    not wait for the work dispatched after it.

    ``push(out, *meta)`` starts ``out``'s copy into pinned host memory on
    the current stream, with an event (a CUDA tensor; any other value is
    kept as it is).  ``drain(item, next_item_or_None)`` is called in FIFO
    order as items retire, ``item[0]`` being the host copy once it has
    landed.  ``depth`` defaults to ``bigdl.pipeline.depth`` (1 = fully
    synchronous)."""

    def __init__(self, drain, depth: Optional[int] = None):
        self.depth = max(1, depth if depth is not None
                         else config.get_int("bigdl.pipeline.depth", 8))
        self._drain = drain
        self._q: deque = deque(maxlen=self.depth)

    def push(self, out, *meta) -> None:
        event = None
        if isinstance(out, torch.Tensor) and out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            out = host
        # drained before the append, so maxlen never evicts an item
        while len(self._q) >= self.depth:
            self._pop()
        self._q.append((out, event) + meta)
        while len(self._q) >= self.depth:
            self._pop()

    def flush(self) -> None:
        while self._q:
            self._pop()

    def abandon(self) -> int:
        """Drop every in-flight item without draining it; returns how many
        were dropped."""
        n = len(self._q)
        self._q.clear()
        return n

    def _pop(self) -> None:
        out, event, *meta = self._q.popleft()
        if event is not None:
            event.synchronize()
        nxt = self._q[0] if self._q else None
        self._drain((out, *meta),
                    None if nxt is None else (nxt[0], *nxt[2:]))


class _StagingSlot:
    """One pinned host buffer per leaf of a batch, reused batch after batch
    once the event of its last copy to the card has completed."""

    def __init__(self):
        self.buffers: list = []
        self.event: Optional[torch.cuda.Event] = None

    def take(self, leaves: list) -> list:
        if self.event is not None:
            self.event.synchronize()     # its last copy has left the buffer
        want = [(tuple(x.shape), x.dtype) for x in leaves]
        if [(tuple(b.shape), b.dtype) for b in self.buffers] != want:
            self.buffers = [torch.empty(s, dtype=d, pin_memory=True)
                            for s, d in want]
        return self.buffers


def _host_tensor(x, zero_copy: bool) -> Optional[torch.Tensor]:
    """An array leaf as a host tensor (None for a scalar or other leaf)."""
    if isinstance(x, np.ndarray):
        return host_tensor(x, zero_copy)
    if isinstance(x, torch.Tensor):
        return x
    return None


class BatchPrefetcher:
    """Background threads running ``fetch()`` ahead of the training loop
    and moving each batch to ``device`` (the JAX package's
    ``BatchPrefetcher``, :87-345).

    ``fetch()`` returns a host batch: a nested list/tuple/dict whose array
    leaves are numpy arrays or host tensors (other leaves, such as a record
    count, pass through).  A call returns the next batch with its arrays on
    ``device``, in the order fetched.

    Threads, as in the JAX package: a fetch thread, the single producer,
    calls ``fetch()`` and then ``on_batch(batch)``, which the trainer uses
    to roll the epoch over (reshuffle, new iterator) on the producer, so
    that the datasets' iterators are touched by one thread and the batch
    sequence does not depend on how far ahead the producer runs.  It
    adopts the constructing thread's
    :class:`~bigdl_tpu_torch.utils.random_generator.RandomGenerator`, so a
    seed set there governs the reshuffles at any depth; each batch carries
    that generator's state after its fetch, and :meth:`stop` puts the
    generator back at the state of the last batch the consumer took, so
    read-ahead that is thrown away leaves it where depth 0 would.  With
    ``transfer_ahead`` > 1 (default ``bigdl.ingest.batchesInFlight``, 2) a
    transfer thread waits for the copies to land while the fetch thread
    fetches and issues the next; both hops are FIFO queues.  An exception
    in a producer re-raises at the call; after :meth:`stop` it is parked on
    ``error``.  :meth:`stop` joins both threads.

    On a CUDA device each fetched batch is copied into a pinned staging
    slot (a ring of ``depth + transfer_ahead`` slots; a slot is reused only
    after the event of its last copy has completed), then to the card with
    ``non_blocking=True`` on a stream of the producer's own, and handed on
    with an event recorded after the copy.  The call makes the consumer's
    current stream wait on that event (on the card, not the host) and
    calls ``record_stream`` on every tensor, so that the caching allocator
    does not reuse its memory before the consumer's work is done.  A batch
    of ``READY_BYTES`` (4 MiB) or more is also waited for on the host by
    the transfer thread (``block_ns``).  On the CPU the batch's arrays
    become host tensors and no stream is used: that is the caller's
    device, not a fallback.  Either way an array leaf becomes a host tensor
    through :func:`host_tensor` (aliased or copied under
    ``bigdl.ingest.zeroCopyUpload``, read when the prefetcher is made).

    ``depth`` defaults to ``bigdl.prefetch.depth`` (2); 0 is synchronous:
    the call fetches and copies on the calling thread and stream.

    Spans (:mod:`~bigdl_tpu_torch.telemetry`, JAX :203-227):
    ``prefetch/fetch`` for each fetch and staging copy, on the
    ``prefetch-fetch`` thread's lane, and ``prefetch/transfer`` for each
    host wait on a large copy, on the ``prefetch-transfer`` lane.

    Counters: ``fetch_ns`` (the producer's time in ``fetch`` and
    ``on_batch`` and the staging copy), ``block_ns`` (waiting for large
    copies to land), ``wait_ns`` (the consumer's time blocked in the call)
    and ``batches``; ``last_fetch_ns`` and ``last_wait_ns`` are those of
    the batch the last call returned.

    Host memory (JAX :153-156, :253): every batch fetched and not yet taken
    charges its staged bytes to the governor's ``prefetch_slots`` account
    (:mod:`~bigdl_tpu_torch.resources.governor`), and a batch larger than
    the whole ``bigdl.resources.hostMemBudgetMB`` raises
    :class:`~bigdl_tpu_torch.resources.errors.HostMemoryError` at the
    call.  The fetch thread starts a fetch only while fewer than ``limit``
    batches are in flight (at first the queues' capacity) and, while the
    governor reports pressure, only when none is; a registered shrinker
    halves ``limit`` (down to 1) at each pressure excursion, for the rest
    of the run.  Either changes when batches are fetched, never which.
    """

    #: batches at or above this size are waited for on the host before
    #: they are handed on
    READY_BYTES = 4 << 20

    def __init__(self, fetch, depth: Optional[int] = None, on_batch=None,
                 transfer_ahead: Optional[int] = None,
                 device: DeviceLike = "cuda", guard=None):
        self.device = default_device(device)
        #: the host-sync guard (:mod:`bigdl_tpu_torch.analysis.hostsync`)
        #: armed around the caller's ``fetch`` on the fetch thread: the
        #: guard is thread-local, and at depth > 0 the fetch runs there
        self._guard = guard
        self.depth = (depth if depth is not None
                      else config.get_int("bigdl.prefetch.depth", 2))
        self.transfer_ahead = (
            transfer_ahead if transfer_ahead is not None
            else config.get_int("bigdl.ingest.batchesInFlight", 2))
        self._fetch = fetch
        self._on_batch = on_batch
        self._zero_copy = config.get_bool("bigdl.ingest.zeroCopyUpload",
                                          True)
        self._stats_lock = make_lock("engine.prefetch")
        self.fetch_ns = 0            # guarded-by: _stats_lock
        self.block_ns = 0            # guarded-by: _stats_lock
        self.wait_ns = 0             # the consumer's alone
        self.batches = 0             # guarded-by: _stats_lock
        self.last_fetch_ns = 0
        self.last_wait_ns = 0
        self._rng = RandomGenerator.RNG()
        self._committed = self._rng.np.get_state()
        #: a producer failure recovered by stop()
        self.error: Optional[BaseException] = None   # guarded-by: _stats_lock
        from bigdl_tpu_torch.resources.governor import GOVERNOR
        self._governor = GOVERNOR
        self._slot_acct = GOVERNOR.account("prefetch_slots")
        if self.depth <= 0:
            return
        #: batches fetched and not yet taken, and the most allowed: the
        #: queues' capacity, halved by each pressure excursion
        self._inflight = 0                           # guarded-by: _room
        self.limit = self.depth + max(1, self.transfer_ahead)
        self._room = threading.Condition(self._stats_lock)
        self._shrink_key = f"prefetch-{id(self)}"
        GOVERNOR.register_shrinker(self._shrink_key, self._shrink)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [_StagingSlot() for _ in
                           range(self.depth + max(1, self.transfer_ahead))]
            self._next_slot = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._transfer_thread = None
        if self.transfer_ahead > 1:
            # issued copies wait here; with the one the transfer thread is
            # waiting for, transfer_ahead are in flight
            self._issued_q: "queue.Queue" = queue.Queue(
                maxsize=self.transfer_ahead - 1)
            self._transfer_thread = threading.Thread(
                target=self._run_transfer, daemon=True,
                name="prefetch-transfer")
            self._transfer_thread.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prefetch-fetch")
        self._thread.start()

    # -- the producer's side ---------------------------------------------

    def _stage(self, batch):
        """The batch's arrays on the device: (batch, event, bytes); the
        event is None off CUDA."""
        leaves = tree_leaves(batch)
        hosts = [_host_tensor(x, self._zero_copy) for x in leaves]
        arrays = [h for h in hosts if h is not None]
        nbytes = sum(h.numel() * h.element_size() for h in arrays)
        if not self._cuda:
            moved = iter([x if h is None else h
                          for h, x in zip(hosts, leaves)])
            return tree_map(lambda _: next(moved), batch), None, nbytes
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        pinned = slot.take(arrays)
        for buf, h in zip(pinned, arrays):
            buf.copy_(h)
        with torch.cuda.stream(self._stream):
            dev = iter([buf.to(self.device, non_blocking=True)
                        for buf in pinned])
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        moved = iter([next(dev) if h is not None else x
                      for h, x in zip(hosts, leaves)])
        return tree_map(lambda _: next(moved), batch), event, nbytes

    def _fetch_once(self):
        t0 = telemetry.clock_ns()
        if self._guard is not None:
            with self._guard.armed():
                batch = self._fetch()
        else:
            batch = self._fetch()
        if self._on_batch is not None:
            self._on_batch(batch)
        batch, event, nbytes = self._stage(batch)
        t1 = telemetry.clock_ns()
        with self._stats_lock:
            self.fetch_ns += t1 - t0
            self.batches += 1
        telemetry.add_span("prefetch/fetch", t0, t1)
        return batch, event, (nbytes, t1 - t0, self._rng.np.get_state())

    def _block_ready(self, event, nbytes: int) -> None:
        if event is None or nbytes < self.READY_BYTES:
            return
        t0 = telemetry.clock_ns()
        event.synchronize()
        t1 = telemetry.clock_ns()
        with self._stats_lock:
            self.block_ns += t1 - t0
        telemetry.add_span("prefetch/transfer", t0, t1, {"bytes": nbytes})

    def _put(self, q, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _shrink(self) -> None:
        """The governor's shrinker: halve the read-ahead limit."""
        with self._room:
            self.limit = max(1, self.limit // 2)

    def _wait_for_room(self) -> bool:
        """Block the fetch thread until it may start a fetch; False when
        stopped."""
        with self._room:
            while not self._stop.is_set():
                cap = 1 if self._governor.under_pressure() else self.limit
                if self._inflight < cap:
                    return True
                self._room.wait(0.05)
        return False

    def _run(self):
        RandomGenerator.adopt(self._rng)
        staged = self._transfer_thread is not None
        out_q = self._issued_q if staged else self._q
        with (torch.cuda.device(self.device) if self._cuda
              else contextlib.nullcontext()):
            while self._wait_for_room():
                try:
                    batch, event, meta = self._fetch_once()
                    self._governor.check_item("prefetch_slots", meta[0])
                    if not staged:
                        self._block_ready(event, meta[0])
                    item = (None, batch, event, meta)
                    with self._room:
                        self._inflight += 1
                    self._slot_acct.add(meta[0])
                except BaseException as e:  # noqa: BLE001 re-raised at call
                    item = (e, None, None, None)
                if not self._put(out_q, item):
                    self._discard(item)
                    return
                if item[0] is not None:
                    return

    def _run_transfer(self):
        with (torch.cuda.device(self.device) if self._cuda
              else contextlib.nullcontext()):
            while not self._stop.is_set():
                try:
                    item = self._issued_q.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item[0] is None:
                    try:
                        self._block_ready(item[2], item[3][0])
                    except BaseException as e:  # noqa: BLE001 re-raised
                        self._taken(item[3][0])
                        item = (e, None, None, None)
                if not self._put(self._q, item):
                    self._discard(item)
                    return
                if item[0] is not None:
                    return

    def _discard(self, item) -> None:
        """An item dropped before the consumer took it: release its
        accounted bytes, then keep any error it carried."""
        if item[0] is None:
            self._taken(item[3][0])
        self._stash_error(item)

    def _stash_error(self, item) -> None:
        """Park the error of an item that could not be handed on; the first
        error wins."""
        with self._stats_lock:
            if item[0] is not None and self.error is None:
                self.error = item[0]

    # -- the consumer's side ---------------------------------------------

    def __call__(self):
        t0 = telemetry.clock_ns()
        if self.depth <= 0:
            batch = self._fetch()
            if self._on_batch is not None:
                self._on_batch(batch)
            # the copy to the device is the fetch's own work (a pageable
            # copy, which the sync debug mode reports), not a host pull
            from bigdl_tpu_torch.analysis.hostsync import allow_host_sync
            with allow_host_sync():
                batch = tree_to_device(batch, self.device)
            t1 = telemetry.clock_ns()
            dt = t1 - t0
            with self._stats_lock:
                self.fetch_ns += dt
                self.batches += 1
            telemetry.add_span("prefetch/fetch", t0, t1)
            self.wait_ns += dt
            self.last_fetch_ns = self.last_wait_ns = dt
            return batch
        while True:
            try:
                err, batch, event, meta = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set() or not self.producer_alive():
                    try:    # a producer hands its last item on, then ends
                        err, batch, event, meta = self._q.get_nowait()
                        break
                    except queue.Empty:
                        raise RuntimeError(
                            "BatchPrefetcher: called after stop() or with "
                            "its producers gone") from self.error
        wait = telemetry.clock_ns() - t0
        self.wait_ns += wait
        self.last_wait_ns = wait
        if err is not None:
            raise err
        self._taken(meta[0])
        _, self.last_fetch_ns, self._committed = meta
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in tree_leaves(batch):
                if isinstance(t, torch.Tensor):
                    t.record_stream(current)
        return batch

    def _taken(self, nbytes: int) -> None:
        self._slot_acct.sub(nbytes)
        with self._room:
            self._inflight -= 1
            self._room.notify_all()

    def producer_alive(self) -> bool:
        """A producer thread is still running (after :meth:`stop`, only if
        its join timed out)."""
        return self.depth > 0 and any(
            t is not None and t.is_alive()
            for t in (self._thread, self._transfer_thread))

    def stop(self) -> None:
        """Stop and join the producers, recover onto ``error`` any producer
        error still queued, and put the adopted generator back at the state
        of the last batch taken."""
        if self.depth <= 0:
            return
        self._stop.set()
        self._governor.unregister_shrinker(self._shrink_key)
        with self._room:
            self._room.notify_all()
        self._thread.join(timeout=10)
        if self._transfer_thread is not None:
            self._transfer_thread.join(timeout=10)
        for q in (self._q, getattr(self, "_issued_q", None)):
            while q is not None:
                try:
                    item = q.get(block=False)
                except queue.Empty:
                    break
                self._discard(item)
        if not self.producer_alive():
            self._rng.np.set_state(self._committed)
        if self._cuda:
            self._stream.synchronize()
