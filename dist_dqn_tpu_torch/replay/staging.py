"""Host<->device batch staging of the host-replay runtime (twin of
``dist_dqn_tpu/replay/staging.py``): H2D double buffering, the streamed
D2H evacuation pipeline, and the sample-ahead prefetcher.

On the card, pinned host buffers and side CUDA streams with events take
the place of the JAX package's ``device_put`` / ``copy_to_host_async``:

* :class:`DoubleBufferedStager` copies each host batch into one of
  ``depth`` reusable pinned buffer sets and uploads it on a side stream,
  recording an event. A set is overwritten only after the event of the
  upload made from it has completed, and the consumer's stream waits on
  the upload's event (never on the whole device) before it reads the
  batch. The uploaded tensors are recorded on the consumer's stream, so
  the allocator does not hand their memory to a later upload while the
  consumer still reads them.
* :class:`StreamedEvacuator` splits a chunk's ``[C, B, ...]`` records into
  time slices, and on a side stream (after the producer stream's work,
  through an event) copies each slice into pinned host memory with an
  event per slice; the records are recorded on the side stream so their
  memory outlives the copies. ``drain`` waits for each slice's event in
  time order and publishes it, so slice k's ring append overlaps slice
  k+1's transfer. :class:`EvacuationWorker` runs the drain on a daemon
  thread behind a per-chunk completion handle.
* :class:`SamplePrefetcher` runs sample -> gather -> stage on a daemon
  thread ahead of the learner, in strict batch-index order, with the ring
  generation handshake of the JAX module.

On the CPU the same classes run with plain tensors and the same threads:
an upload is a copy (a batch never aliases a staging buffer it may be
overwritten through), and a slice is a host view of the records.

The JAX module's telemetry, heartbeats, flight records and chaos seams
are not ported yet.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------
# Trees of arrays: tuples, NamedTuples, lists and dicts over leaves.
# --------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[list, Callable[[list], Any]]:
    """(leaves, rebuild): the leaves of a tree of tuples, NamedTuples,
    lists and dicts (dicts in key order), and the function that builds the
    same tree around a new list of leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [tree_flatten(x) for x in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new_leaves: list):
        out, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(new_leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)

    return leaves, rebuild


def tree_map(fn, tree):
    leaves, rebuild = tree_flatten(tree)
    return rebuild([fn(x) for x in leaves])


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class DoubleBufferedStager:
    """FIFO of in-flight H2D uploads over ``depth`` reusable buffer sets.

    ``stage(host_batch, aux=...)`` copies a tree of numpy arrays into the
    next staging set and starts its upload to ``device``; ``pop()`` returns
    ``(device_batch, aux)`` oldest first. ``aux`` carries host bookkeeping
    (replay indices, write generations) beside the batch. ``depth`` bounds
    host memory and how far sampling may run ahead of training.
    """

    def __init__(self, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"stager depth must be >= 1, got {depth}")
        self.depth = depth
        self.device = torch.device("cpu" if device is None else device)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self._cuda else None)
        # Host staging sets, allocated from the first batch (pinned on the
        # card), and the event of the upload last made from each set.
        self._bufs: List[Optional[List[torch.Tensor]]] = [None] * depth
        self._events: List[Optional[torch.cuda.Event]] = [None] * depth
        self._specs = None
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._queued = 0
        self._lock = threading.Lock()
        self._staged_total = 0
        self.bytes_staged = 0

    def __len__(self) -> int:
        return self._queued

    @property
    def staged_total(self) -> int:
        return self._staged_total

    def stage(self, host_batch: Any, aux: Any = None) -> None:
        """Copy ``host_batch`` into the next staging set and begin its
        upload."""
        if self._queued >= self.depth:
            raise RuntimeError(
                f"stager depth {self.depth} exceeded: pop() before "
                "staging further batches")
        leaves, rebuild = tree_flatten(host_batch)
        arrays = [np.asarray(leaf) for leaf in leaves]
        specs = [(a.shape, a.dtype) for a in arrays]
        if self._specs is None:
            self._specs = specs
        elif specs != self._specs:
            raise ValueError(
                f"staged leaves {specs} do not match the staging buffers "
                f"{self._specs}")
        slot = self._staged_total % self.depth
        bufs = self._bufs[slot]
        if bufs is None:
            bufs = [torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                                pin_memory=self._cuda) for a in arrays]
            self._bufs[slot] = bufs
        elif self._events[slot] is not None:
            # Reuse barrier: the upload last made from this set must have
            # read its pages. In steady state it finished long ago.
            self._events[slot].synchronize()
        nbytes = 0
        for buf, a in zip(bufs, arrays):
            np.copyto(buf.numpy(), a)
            nbytes += a.nbytes
        if self._cuda:
            with torch.cuda.stream(self._stream):
                dev = [b.to(self.device, non_blocking=True) for b in bufs]
                event = torch.cuda.Event()
                event.record(self._stream)
            self._events[slot] = event
        else:
            dev, event = [b.clone() for b in bufs], None
        with self._lock:
            self._queued += 1
        self._queue.put((rebuild(dev), event, aux))
        self._staged_total += 1
        self.bytes_staged += nbytes

    def pop(self) -> Tuple[Any, Any]:
        """Oldest staged ``(device_batch, aux)``; raises when empty. On the
        card the current stream waits for the batch's upload."""
        if not self._queued:
            raise RuntimeError("pop() on an empty stager — stage() first")
        batch, event, aux = self._queue.get()
        with self._lock:
            self._queued -= 1
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for x in tree_flatten(batch)[0]:
                x.record_stream(consumer)
        return batch, aux


def _slice_bounds(length: int, num_slices: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [lo, hi) time slices covering [0, length)."""
    k = max(1, min(int(num_slices), int(length)))
    base, rem = divmod(int(length), k)
    bounds, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


class _EvacJob:
    """One chunk's in-flight evacuation: per slice its host leaves and the
    event its copies complete at, plus the completion handle state."""

    def __init__(self, slices, bounds, rebuild, submitted_at: float):
        self.slices = slices            # [k] (host leaves, event or None)
        self.bounds = bounds            # [k] (lo, hi)
        self.rebuild = rebuild
        self.submitted_at = submitted_at
        self.stats: dict = {}
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every slice of this chunk is appended (or the worker
        failed, whose exception this re-raises)."""
        ok = self._done.wait(timeout)
        if self._exc is not None:
            raise self._exc
        return ok

    @property
    def done(self) -> bool:
        return self._done.is_set() and self._exc is None

    def _finish(self, stats: dict) -> None:
        self.stats = stats
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()


class StreamedEvacuator:
    """Streamed sub-chunk D2H evacuation.

    ``start(records)`` splits a tree of ``[C, B, ...]`` tensors into
    ``num_slices`` contiguous time slices and starts every slice's copy
    into pinned host memory on a side stream; it returns an ``_EvacJob``
    and never blocks. ``drain(job, on_slice)`` walks the slices in time
    order, waiting for each slice's event, and calls ``on_slice(tree, lo,
    hi)`` with numpy views, valid only within that call (the ring copies
    them in ``add_chunk``).
    """

    def __init__(self, num_slices: int = 4):
        if num_slices < 1:
            raise ValueError(
                f"evacuator num_slices must be >= 1, got {num_slices}")
        self.num_slices = int(num_slices)
        self._stream: Optional["torch.cuda.Stream"] = None
        self.bytes_total = 0
        self.slices_total = 0

    def start(self, records: Any,
              ready: Optional["torch.cuda.Event"] = None) -> _EvacJob:
        """Start the slice copies of one chunk. On the card the copies wait
        for ``ready``, the event at which the producer's records are
        complete (default: everything queued on the current stream so
        far), so they overlap the work queued after it."""
        leaves, rebuild = tree_flatten(records)
        C = int(leaves[0].shape[0])
        bounds = _slice_bounds(C, self.num_slices)
        device = leaves[0].device
        if device.type != "cuda":
            slices = [([x[lo:hi].numpy() for x in leaves], None)
                      for lo, hi in bounds]
            return _EvacJob(slices, bounds, rebuild, time.perf_counter())
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=device)
        stream = self._stream
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        slices = []
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for x in leaves:
                x.record_stream(stream)
            for lo, hi in bounds:
                host = []
                for x in leaves:
                    h = torch.empty(x[lo:hi].shape, dtype=x.dtype,
                                    pin_memory=True)
                    h.copy_(x[lo:hi], non_blocking=True)
                    host.append(h)
                event = torch.cuda.Event()
                event.record(stream)
                slices.append((host, event))
        return _EvacJob(slices, bounds, rebuild, time.perf_counter())

    def drain(self, job: _EvacJob,
              on_slice: Callable[[Any, int, int], None]) -> dict:
        """Wait for and publish every slice of ``job`` in time order;
        returns the chunk's stats (bytes, slices, evac_s)."""
        nbytes = 0
        for i, ((host, event), (lo, hi)) in enumerate(zip(job.slices,
                                                          job.bounds)):
            if event is not None:
                event.synchronize()
            arrays = [h if isinstance(h, np.ndarray) else h.numpy()
                      for h in host]
            nbytes += sum(a.nbytes for a in arrays)
            on_slice(job.rebuild(arrays), lo, hi)
            # Release the slice's buffers once published.
            job.slices[i] = None
            self.slices_total += 1
        self.bytes_total += nbytes
        return {"bytes": nbytes, "slices": len(job.bounds),
                "evac_s": time.perf_counter() - job.submitted_at}


class EvacuationWorker:
    """Background D2H evacuation: drains ``StreamedEvacuator`` jobs on a
    daemon thread, so transfer waits and ring appends never block the
    training loop.

    ``submit(records)`` runs ``evacuator.start`` on the caller's thread and
    queues the drain; the returned job is the completion handle the loop
    fences on (``job.wait()``). A worker exception fails the in-flight job
    and every queued one, re-raises from ``wait()`` and the next
    ``submit()``, and the thread stays as a tombstone that fails what
    arrives until ``close()``.
    """

    def __init__(self, evacuator: StreamedEvacuator,
                 on_slice: Callable[[Any, int, int], None],
                 name: str = "host_replay"):
        self._evac = evacuator
        self._on_slice = on_slice
        self._q: "queue.Queue" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"evac-{name}", daemon=True)
        self._thread.start()

    def submit(self, records: Any,
               ready: Optional["torch.cuda.Event"] = None) -> _EvacJob:
        if self._exc is not None:
            raise RuntimeError(
                "evacuation worker died; no further chunks can be "
                "evacuated") from self._exc
        if not self._thread.is_alive():
            raise RuntimeError("evacuation worker is closed")
        job = self._evac.start(records, ready)
        self._q.put(job)
        return job

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job._finish(self._evac.drain(job, self._on_slice))
            except BaseException as e:  # propagate, never hang the fence
                self._exc = e
                job._fail(e)
                while True:
                    pending = self._q.get()
                    if pending is None:
                        return
                    pending._fail(e)

    def close(self) -> None:
        """Stop the worker and join; queued jobs finish first."""
        self._q.put(None)
        self._thread.join()

    @property
    def failed(self) -> Optional[BaseException]:
        return self._exc


class SamplePrefetcher:
    """Background sample-ahead pipeline: a daemon thread runs
    ``sample_fn(k) -> (host_batch, aux)`` and stages each result through an
    internal :class:`DoubleBufferedStager`; the training loop pops device
    batches in strict ``k`` order.

    Batch ``k``'s content must be a pure function of ``(k, ring window)``
    (its RNG a per-index stream), which makes the prefetched path
    bit-identical to the serial one: thread timing changes when a batch is
    drawn, never what it holds.

    ``request(n, min_generation)`` tags the work with the ring generation
    the coming train event fenced on; the worker waits for that generation
    before sampling, and ``pop(min_generation)`` re-checks the tag the
    sample carried: a batch drawn against an older window is counted in
    ``stale_total``, dropped and re-drawn on the calling thread. A worker
    exception re-raises from ``pop()``/``request()``.
    """

    def __init__(self, sample_fn: Callable[[int], Tuple[Any, Any]],
                 depth: int = 2, name: str = "host_replay",
                 wait_generation: Optional[Callable] = None,
                 device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._sample_fn = sample_fn
        self._wait_gen = wait_generation
        self.depth = int(depth)
        self._stager = DoubleBufferedStager(depth=depth, device=device)
        self._work: "queue.Queue" = queue.Queue()
        self._ready = threading.Semaphore(0)
        self._free = threading.Semaphore(depth)
        self._exc: Optional[BaseException] = None
        self._closing = False
        self._next_k = 0
        self.sample_s_total = 0.0
        self.wait_s_total = 0.0
        self.stale_total = 0
        self.sampled_total = 0
        self._thread = threading.Thread(target=self._run,
                                        name=f"prefetch-{name}",
                                        daemon=True)
        self._thread.start()

    def __len__(self) -> int:
        """Batches staged and not yet popped."""
        return len(self._stager)

    @property
    def next_k(self) -> int:
        """The next batch index request() hands out."""
        return self._next_k

    def seek(self, k: int) -> None:
        """Move the batch-index cursor (checkpoint resume); only while
        idle."""
        if self._work.qsize() or len(self._stager):
            raise RuntimeError("seek() on a prefetcher with work in "
                               "flight")
        self._next_k = int(k)

    @property
    def bytes_staged(self) -> int:
        """Host bytes copied through the internal staging buffers."""
        return self._stager.bytes_staged

    def request(self, n: int, min_generation: int) -> None:
        """Enqueue the next ``n`` batch indices, to be drawn against a ring
        window of at least ``min_generation``."""
        if self._exc is not None:
            raise RuntimeError(
                "sample prefetcher died; no further batches can be "
                "prefetched") from self._exc
        if self._closing or not self._thread.is_alive():
            raise RuntimeError("sample prefetcher is closed")
        for _ in range(int(n)):
            self._work.put((self._next_k, int(min_generation)))
            self._next_k += 1

    def _resample(self, k: int, min_generation: int) -> Tuple[Any, Any]:
        """Stale-batch backstop: re-draw batch ``k`` on the calling thread
        once the ring reaches ``min_generation``."""
        deadline = time.monotonic() + 30.0
        while True:
            reached = (self._wait_gen(
                min_generation,
                timeout=max(deadline - time.monotonic(), 0.0))
                if self._wait_gen is not None else True)
            if reached:
                host_batch, aux = self._sample_fn(k)
                if getattr(aux, "generation", min_generation) \
                        >= min_generation:
                    stager = DoubleBufferedStager(
                        depth=1, device=self._stager.device)
                    stager.stage(host_batch)
                    return stager.pop()[0], aux
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"prefetch batch {k} waited 30s for ring "
                    f"generation {min_generation} which never "
                    "published — appends stopped while a train event "
                    "still expected them")
            if self._wait_gen is None:
                time.sleep(0.01)

    def pop(self, min_generation: int) -> Tuple[Any, Any]:
        """Next batch in ``k`` order -> (device_batch, aux)."""
        t0 = time.perf_counter()
        while not self._ready.acquire(timeout=0.1):
            if self._exc is not None:
                raise self._exc
            if self._closing or not self._thread.is_alive():
                raise RuntimeError("sample prefetcher is closed")
        device_batch, (k, aux) = self._stager.pop()
        self._free.release()
        if getattr(aux, "generation", min_generation) < min_generation:
            self.stale_total += 1
            device_batch, aux = self._resample(k, min_generation)
        self.wait_s_total += time.perf_counter() - t0
        return device_batch, aux

    def _run(self) -> None:
        timeout = 0.5
        while True:
            try:
                item = self._work.get(timeout=timeout)
            except queue.Empty:
                if self._closing:
                    return
                continue
            if item is None:
                return
            k, min_gen = item
            try:
                if self._wait_gen is not None:
                    while not self._wait_gen(min_gen, timeout=timeout):
                        if self._closing:
                            return
                while not self._free.acquire(timeout=timeout):
                    if self._closing:
                        return
                t0 = time.perf_counter()
                host_batch, aux = self._sample_fn(k)
                self.sample_s_total += time.perf_counter() - t0
                self.sampled_total += 1
                self._stager.stage(host_batch, aux=(k, aux))
                self._ready.release()
            except BaseException as e:  # propagate, never hang a pop
                self._exc = e
                while True:
                    try:
                        pending = self._work.get(timeout=timeout)
                    except queue.Empty:
                        if self._closing:
                            return
                        continue
                    if pending is None:
                        return

    def close(self) -> None:
        """Stop the worker and join; staged-but-unpopped batches are
        discarded."""
        self._closing = True
        self._work.put(None)
        self._thread.join()

    @property
    def failed(self) -> Optional[BaseException]:
        return self._exc
