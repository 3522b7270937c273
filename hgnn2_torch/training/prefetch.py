"""Host-side batch prefetching (counterpart of
hgnn2_tpu/training/prefetch.py).

Batch assembly (padding, packing) and the copy to the device run on the
host; prefetch(loader) builds batches in a background thread, keeping
``size`` batches in flight, so the host can build the next batch while
the current step is enqueued. On CUDA the thread copies on its current
stream, the device's default one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Yields the items of ``iterable`` in order, built ``size`` items
    ahead in a background thread. Its exceptions re-raise at the
    consuming site."""
    q: queue.Queue = queue.Queue(maxsize=size)

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
