"""Batch loading in worker processes, delivered through shared memory (port
of ``vision_pt_tpu/data/worker_pool.py``): torch's ``DataLoader(num_workers=N)``
made explicit, for buckets whose batches have fixed shapes.

Processes, not threads: a bucket's decode releases the GIL (ctypes, PIL),
but every item still needs Python glue (draws, captions, collation) that
would contend with the training loop's own dispatch. A worker owns its GIL;
the consumer does a zero-copy read of shared memory and the copy to the
device.

- ``BatchWorkerPool(make_batch, indices, ...)`` starts N workers. Each takes
  ``(seq, index, slot)`` tasks, runs ``make_batch(index)`` (a dict of numpy
  arrays and other fields), writes the arrays into the slot's preallocated
  ``SharedMemory`` and sends the other fields through the result queue.
- The array schema (shapes and dtypes) is probed once, in-process, from the
  batch of ``indices[0]``, so slots are sized exactly; there are
  ``depth + num_workers`` slots.
- The consumer restores ``seq`` order, yields each batch with its arrays as
  views into shared memory, and recycles the slot when the paired
  ``release()`` is called: only after the copy out of it is complete.
- ``iter_device(to_device)`` wraps that protocol: ``to_device(batch)`` must
  return with its copies done (:func:`to_device` copies on a side stream and
  waits on that stream's event, not on the compute stream), then the slot is
  released.

Fork is the default start method: the workers inherit the bucket with no
pickling or re-import. They must not touch ``torch.cuda`` (a forked child
cannot use its parent's CUDA context): ``make_batch`` runs numpy, PIL and
ctypes only. ``ctx="spawn"`` gives a clean child for a picklable
``make_batch``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import time
from multiprocessing import shared_memory
from typing import Any, Callable, Iterable, Iterator

import numpy as np

__all__ = ["BatchWorkerPool", "infinite_indices", "pool_cpu_budget", "to_device"]


def _probe_schema(batch: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    return {
        k: (v.shape, v.dtype.str)
        for k, v in batch.items()
        if isinstance(v, np.ndarray)
    }


def _slot_views(shm: shared_memory.SharedMemory,
                schema: dict[str, tuple[tuple[int, ...], str]]) -> dict[str, np.ndarray]:
    views: dict[str, np.ndarray] = {}
    offset = 0
    for key, (shape, dtype_str) in schema.items():
        dt = np.dtype(dtype_str)
        n = int(np.prod(shape)) * dt.itemsize
        views[key] = np.ndarray(shape, dtype=dt, buffer=shm.buf, offset=offset)
        offset += -(-n // 64) * 64  # keep each field 64-byte aligned
    return views


def _slot_nbytes(schema: dict[str, tuple[tuple[int, ...], str]]) -> int:
    total = 0
    for shape, dtype_str in schema.values():
        n = int(np.prod(shape)) * np.dtype(dtype_str).itemsize
        total += -(-n // 64) * 64
    return max(total, 64)


def _worker_main(make_batch, schema, slot_names, task_q, result_q):
    """Worker loop: decode batches into shared-memory slots, without CUDA."""
    slots = {
        name: shared_memory.SharedMemory(name=name) for name in slot_names
    }
    views = {name: _slot_views(shm, schema) for name, shm in slots.items()}
    try:
        while True:
            task = task_q.get()
            if task is None:
                break
            seq, index, slot = task
            try:
                t0 = time.perf_counter()
                batch = make_batch(index)
                meta: dict[str, Any] = {}
                for key, value in batch.items():
                    if isinstance(value, np.ndarray):
                        dst = views[slot][key]
                        if value.shape != dst.shape:
                            raise ValueError(
                                f"batch field {key!r} shape {value.shape} != "
                                f"probed schema {dst.shape} (worker pools "
                                "need fixed shapes; use one pool per bucket)"
                            )
                        dst[...] = value
                    else:
                        meta[key] = value
                result_q.put(
                    (seq, slot, meta, time.perf_counter() - t0, None)
                )
            except Exception as e:  # noqa: BLE001 — re-raised in consumer
                import traceback

                result_q.put(
                    (seq, slot, None, 0.0,
                     f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
                )
    finally:
        for shm in slots.values():
            shm.close()


class BatchWorkerPool:
    """Decode batches in worker processes, deliver through shared memory.

    ``make_batch(index) -> dict`` runs in the workers; ``indices`` is any
    (possibly infinite) iterable of indices; batches come back in ``indices``
    order. All array fields must have a fixed shape across batches (one pool
    per aspect-ratio bucket).
    """

    def __init__(
        self,
        make_batch: Callable[[int], dict],
        indices: Iterable[int],
        *,
        num_workers: int = 1,
        depth: int = 3,
        ctx: str = "fork",
        probe_index: int | None = None,
    ):
        self._make_batch = make_batch
        self._indices = iter(indices)
        self._num_workers = max(1, int(num_workers))
        self._depth = max(2, int(depth))
        self._closed = False

        # schema probe: one in-process batch defines every slot's layout.
        # When it consumed indices[0], the probe batch itself is yielded
        # first so the stream stays exactly ``indices`` order.
        first_index = next(self._indices) if probe_index is None else probe_index
        probe = make_batch(first_index)
        self._schema = _probe_schema(probe)
        self._pending_probe = probe if probe_index is None else None

        n_slots = self._depth + self._num_workers
        nbytes = _slot_nbytes(self._schema)
        self._shms: list[shared_memory.SharedMemory] = []
        for _ in range(n_slots):
            self._shms.append(
                shared_memory.SharedMemory(create=True, size=nbytes)
            )
        self._views = {
            shm.name: _slot_views(shm, self._schema) for shm in self._shms
        }

        mp_ctx = mp.get_context(ctx)
        self._task_q = mp_ctx.Queue()
        self._result_q = mp_ctx.Queue()
        self._free_slots: list[str] = [shm.name for shm in self._shms]
        self._seq_submitted = 0
        self._seq_delivered = 0
        self._reorder: dict[int, tuple] = {}
        # stats for boundedness diagnosis: how long the consumer waited on
        # workers vs how long workers spent decoding
        self.consumer_wait_s = 0.0
        self.worker_decode_s = 0.0
        self.batches_delivered = 0

        self._workers = [
            mp_ctx.Process(
                target=_worker_main,
                args=(make_batch, self._schema,
                      [shm.name for shm in self._shms],
                      self._task_q, self._result_q),
                daemon=True,
            )
            for _ in range(self._num_workers)
        ]
        for w in self._workers:
            w.start()
        self._fill_tasks()

    # ------------------------------------------------------------ internals

    def _fill_tasks(self) -> None:
        while self._free_slots:
            try:
                index = next(self._indices)
            except StopIteration:
                return
            slot = self._free_slots.pop()
            self._task_q.put((self._seq_submitted, index, slot))
            self._seq_submitted += 1

    def _next_result(self) -> tuple[dict, Callable[[], None]]:
        seq_wanted = self._seq_delivered
        t0 = time.perf_counter()
        while seq_wanted not in self._reorder:
            try:
                seq, slot, meta, decode_s, err = self._result_q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [w.exitcode for w in self._workers if not w.is_alive()]
                if dead:  # e.g. SIGBUS on a full /dev/shm: raise, do not hang
                    self.close()
                    raise RuntimeError(f"a batch worker exited with code {dead[0]}")
                continue
            if err is not None:
                self.close()
                raise RuntimeError(f"worker batch failed: {err}")
            self._reorder[seq] = (slot, meta, decode_s)
        self.consumer_wait_s += time.perf_counter() - t0
        slot, meta, decode_s = self._reorder.pop(seq_wanted)
        self.worker_decode_s += decode_s
        self._seq_delivered += 1
        self.batches_delivered += 1

        batch = dict(meta)
        for key in self._schema:
            batch[key] = self._views[slot][key]

        released = [False]

        def release() -> None:
            if released[0] or self._closed:
                return
            released[0] = True
            self._free_slots.append(slot)
            self._fill_tasks()

        return batch, release

    # ------------------------------------------------------------ consumers

    def __iter__(self) -> Iterator[tuple[dict, Callable[[], None]]]:
        """Yield ``(batch, release)`` pairs in index order. Arrays are
        zero-copy shared-memory views: call ``release()`` once the batch has
        been copied out (its copy complete) to recycle the slot."""
        if self._pending_probe is not None:
            probe, self._pending_probe = self._pending_probe, None
            self.batches_delivered += 1
            yield probe, lambda: None
        while self._seq_delivered < self._seq_submitted or self._reorder:
            yield self._next_result()

    def iter_device(self, to_device: Callable[[dict], Any]) -> Iterator[Any]:
        """Yield ``to_device(batch)`` results, each slot released right after
        ``to_device`` returns: it must return with its copies complete (see
        :func:`to_device`)."""
        for batch, release in self:
            out = to_device(batch)
            release()
            yield out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            try:
                self._task_q.put_nowait(None)
            except Exception:  # noqa: BLE001
                pass
        deadline = time.time() + 5
        for w in self._workers:
            w.join(timeout=max(0.1, deadline - time.time()))
            if w.is_alive():
                w.terminate()
        for shm in self._shms:
            try:
                shm.close()
                shm.unlink()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "BatchWorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def pool_cpu_budget() -> int:
    """Workers that make sense on this host: its cores less one for the
    training loop, at least 1 (on one core a worker still keeps the decode
    off the loop's GIL)."""
    return max(1, (os.cpu_count() or 1) - 1)


def infinite_indices(num_batches: int) -> Iterator[int]:
    """0..n-1 repeated forever (steady-state feeding)."""
    while True:
        yield from range(num_batches)


_COPY_STREAMS: dict = {}


def to_device(batch: dict, device) -> dict:
    """Every array of the batch as a tensor on ``device`` (a copy, never a
    view of the slot), other fields as they are.

    On a CUDA device each array is staged into pinned host memory and copied
    on a side stream; the call waits on an event recorded on that stream
    only, and the current stream waits on the same event before it reads the
    tensors. So the slot may be recycled as soon as the call returns, while
    the host goes on dispatching ahead of the card's queued kernels."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device, copy=True)
                if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = _COPY_STREAMS.get(device)
    if side is None:
        side = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    out = dict(batch)
    with torch.cuda.stream(side):
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                src = torch.from_numpy(v)
                staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                staged.copy_(src)
                out[k] = staged.to(device, non_blocking=True)
                out[k].record_stream(compute)  # allocated on side, read on compute
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    compute.wait_event(done)
    return out
