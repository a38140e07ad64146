"""JPEG-decode worker processes for the host-fed infeed (counterpart of
video_dqn_tpu/data/workers.py `parallel_batches`, TPU.DECODE_WORKERS).

N forked processes each inherit the parent's QLearningBatcher and decode
the rows the parent sends them; the parent emits the batches in the order
it drew their rows, so the stream depends on the seed alone:
np.random.default_rng(seed).integers(0, n, B) a batch, as the JAX
package's stream. Frames travel through fork-inherited shared-memory
slots, (2, B, F, S, S, 3) uint8 each, copied out once by the parent; the
labels ride the result queue.

One in-process decode call already threads across every core
(data/jpeg.py), so workers pay only where decode must overlap other host
work. Each worker decodes on cores / workers threads
(VDQN_JPEG_THREADS). The workers fork when `parallel_batches` is called,
before any CUDA work: it raises once CUDA is initialized, since a forked
child of a CUDA process cannot be trusted. The host library is built and
loaded in the parent first, so the children never build it at once.
A worker's exception (a file that will not decode names its path) is
raised in the parent; closing the stream terminates and joins every
child.
"""

from __future__ import annotations

import ctypes
import multiprocessing as mp
import os
import queue as queue_mod
from typing import Dict

import numpy as np
import torch

from .. import _build
from .qlearning import QLearningBatcher

LABEL_KEYS = ("action", "reward", "terminal", "gt", "valid_mask")
QUEUE_DEPTH = 4  # batches in flight a worker, as the JAX package's default
RESULT_TIMEOUT_S = 10.0  # between checks that some worker is still alive


def _worker_loop(batcher, index_q, out_q, jpeg_threads, slots, slot_shape):
    os.environ["VDQN_JPEG_THREADS"] = str(jpeg_threads)
    views = [np.frombuffer(s, np.uint8).reshape(slot_shape) for s in slots]
    while True:  # until the parent terminates it
        seq, indices, slot_id = index_q.get()
        try:
            batch = batcher.get_batch(np.asarray(indices))
            views[slot_id][0] = batch["before"]
            views[slot_id][1] = batch["after"]
            out_q.put((seq, slot_id, {k: batch[k] for k in LABEL_KEYS}))
        except Exception as e:  # raised in the parent
            out_q.put((seq, None, e))
            return


class WorkerBatches:
    """The endless iterator `parallel_batches` returns: batches in
    submission order. `close()` (also as a context manager, on an error
    and at garbage collection) terminates and joins the workers: the
    batches they are decoding are not wanted."""

    def __init__(self, n, batch_size, seed, index_q, out_q, procs, slots, slot_shape):
        self.n, self.batch_size = n, batch_size
        self.index_q, self.out_q, self.procs = index_q, out_q, procs
        self.rng = np.random.default_rng(seed)
        self.n_slots = len(slots)
        self.free_slots = list(range(self.n_slots))
        self.views = [np.frombuffer(s, np.uint8).reshape(slot_shape) for s in slots]
        self.pending: Dict[int, dict] = {}
        self.submitted = self.emitted = 0
        self.closed = False

    def __iter__(self) -> "WorkerBatches":
        return self

    def __enter__(self) -> "WorkerBatches":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _submit(self) -> None:
        """Keep the index queue primed, as far as free slots allow (a slot
        is writable again once the parent copied its batch out)."""
        while self.submitted - self.emitted < self.n_slots and self.free_slots:
            idx = self.rng.integers(0, self.n, self.batch_size)
            try:
                self.index_q.put((self.submitted, idx.tolist(), self.free_slots[-1]),
                                 timeout=0.2)
            except queue_mod.Full:
                return
            self.free_slots.pop()
            self.submitted += 1

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.closed:
            raise StopIteration
        try:
            while self.emitted not in self.pending:
                self._submit()
                try:
                    seq, slot_id, result = self.out_q.get(timeout=RESULT_TIMEOUT_S)
                except queue_mod.Empty:
                    if not any(p.is_alive() for p in self.procs):
                        raise RuntimeError("all decode workers died") from None
                    continue
                if isinstance(result, Exception):
                    raise result
                result = dict(result)
                result["before"] = np.array(self.views[slot_id][0])  # the one copy out
                result["after"] = np.array(self.views[slot_id][1])
                self.pending[seq] = result
                self.free_slots.append(slot_id)
        except BaseException:
            self.close()
            raise
        self.emitted += 1
        return self.pending.pop(self.emitted - 1)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            p.join()
        for q in (self.out_q, self.index_q):
            q.cancel_join_thread()
            q.close()

    def __del__(self):
        self.close()


def parallel_batches(batcher: QLearningBatcher, batch_size: int, num_workers: int = 2,
                     seed: int = 0) -> WorkerBatches:
    """An endless shuffled stream of `batcher.get_batch` batches of
    `batch_size` rows, decoded by `num_workers` processes forked here,
    each with the parent's `batcher`, QUEUE_DEPTH batches in flight a
    worker. Call it before any CUDA work."""
    if torch.cuda.is_initialized():
        raise RuntimeError(
            "parallel_batches forks its decode workers and must start before CUDA is "
            "initialized in this process (run_train starts it before the model)")
    _build.load_host()  # built once, here, before the children fork
    ctx = mp.get_context("fork")
    n_slots = QUEUE_DEPTH * max(1, num_workers)
    size = batcher.image_size
    slot_shape = (2, batch_size, batcher.num_frames, size, size, 3)
    # anonymous fork-inherited buffers: no names, freed with the processes
    slots = [ctx.RawArray(ctypes.c_ubyte, int(np.prod(slot_shape))) for _ in range(n_slots)]
    jpeg_threads = max(1, (os.cpu_count() or 1) // max(1, num_workers))
    index_q, out_q = ctx.Queue(maxsize=n_slots), ctx.Queue(maxsize=n_slots)
    procs = [ctx.Process(target=_worker_loop, daemon=True,
                         args=(batcher, index_q, out_q, jpeg_threads, slots, slot_shape))
             for _ in range(num_workers)]
    for p in procs:
        p.start()
    return WorkerBatches(len(batcher), batch_size, seed, index_q, out_q, procs, slots, slot_shape)
