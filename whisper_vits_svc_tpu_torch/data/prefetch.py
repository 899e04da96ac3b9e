"""Background-thread batch prefetching (JAX whisper_vits_svc_tpu/data/prefetch.py).

One daemon thread and a bounded queue stand in for the reference's
DataLoader worker processes: the per-batch host work is file reads and a
numpy collate (through the native loader where it builds), while the card
runs the previous step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()
_POLL_S = 0.1  # how often a producer blocked on a full queue looks for a stop


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate `iterable` on a daemon thread, keeping `depth` items ready.
    An exception raised by the producer is raised again in the consumer.
    When the consumer stops early (a break, an exception, close()), the
    producer stops after its current item and the thread is joined, so no
    thread is left holding batches."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in iterable:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True, name="prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()
