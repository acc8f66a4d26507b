"""Threaded prefetching around the host-side video and chunk producers.

Port of ``diffusionvid_tpu/data/prefetch.py``.  The reference feeds the GPU
through a DataLoader with ``NUM_WORKERS=16`` worker processes; here the
decode and resize work (``cv2`` releases the interpreter lock) runs in a
thread pool that keeps a bounded queue of ready items ahead of the card.
The producers touch numpy only: the consumer thread alone moves frames to
the card.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional


class PrefetchIterator:
    """Wrap any iterator with a background-thread bounded prefetch queue.
    Order is kept; a producer's exception is raised in the consumer;
    ``close()`` releases the producer thread.

    On a single-CPU host threads cannot overlap anything and the
    producer/consumer hand-off only costs, so the wrapper passes the
    iterator through."""

    _END = object()

    def __init__(self, iterator: Iterator, depth: int = 4):
        self._passthrough = (os.cpu_count() or 1) <= 1
        self._closed = False
        if self._passthrough:
            self._it = iter(iterator)
            return
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up once the consumer has closed: an
        abandoned consumer (run_inference stopping at max_videos) must not
        leave this thread blocked holding decoded frames."""
        while not self._closed:
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, iterator):
        try:
            for item in iterator:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            self._err = e
        finally:
            # the end marker waits for room like any item: dropped on a
            # full queue, it would leave the consumer waiting for ever
            self._put(self._END)

    def close(self):
        """Stop the producer, release its buffers and wait for its thread,
        which ends after the item it is making (idempotent)."""
        self._closed = True
        if not self._passthrough:
            # drain so a producer blocked in put() can observe _closed
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        if self._passthrough:
            return next(self._it)
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch_map(fn: Callable, items, workers: int = 8, depth: int = 16):
    """Ordered parallel map with bounded lookahead: a thread pool evaluates
    ``fn(item)`` ahead of consumption.  Workers are capped at the CPU
    count; on a single-core host it is a plain generator."""
    workers = max(1, min(workers, os.cpu_count() or 1))
    depth = max(depth, workers)
    if (os.cpu_count() or 1) <= 1:
        return (fn(x) for x in items)

    def gen():
        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = []
            it = iter(items)
            try:
                for _ in range(depth):
                    pending.append(pool.submit(fn, next(it)))
            except StopIteration:
                it = None
            while pending:
                out = pending.pop(0).result()
                if it is not None:
                    try:
                        pending.append(pool.submit(fn, next(it)))
                    except StopIteration:
                        it = None
                yield out

    return gen()
