"""Double-buffered host -> device batch prefetch (port of data/prefetch.py).

:func:`prefetch_to_device` stages the next batches from a daemon thread
while the current step runs, with the JAX function's order, exception and
abandonment semantics.  :class:`DevicePut` is its ``put_fn`` for a batch
of numpy arrays: on the card it copies them from pinned host memory on a
side stream and records an event; the consumer calls
:meth:`Staged.wait`, which makes its own stream wait on that event and
tells the allocator (``record_stream``) that the tensors are used there,
so their memory is not reused before the step that reads them is done.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def prefetch_to_device(batches: Iterable, put_fn: Callable,
                       depth: int = 2) -> Iterator:
    """Yield ``put_fn(batch)`` for each batch, staged ``depth`` ahead by a
    daemon thread.  An exception in the thread is raised again where the
    consumer takes the next item.  Abandoning the iterator (an exception
    in the consumer, an early ``break``) sets a closed flag that the thread
    checks around its bounded ``put``, so it ends and drops its staged
    batches instead of blocking forever with them held on the device."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(put_fn(b)):
                    return
            put(end)
        except BaseException as e:          # noqa: BLE001 - raised below
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        closed.set()


class Staged:
    """A batch of device tensors and the event its copies end at (``None``
    on the CPU)."""

    def __init__(self, tensors: Dict[str, Optional[torch.Tensor]],
                 event: Optional[torch.cuda.Event]):
        self._tensors = tensors
        self._event = event

    def wait(self) -> Dict[str, Optional[torch.Tensor]]:
        """The tensors, ready for work queued on the current stream from
        now on."""
        if self._event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self._event)
            for t in self._tensors.values():
                if t is not None:
                    t.record_stream(stream)
        return self._tensors


class DevicePut:
    """``put_fn`` for :func:`prefetch_to_device`: ``{key: numpy array or
    None}`` -> :class:`Staged` on ``device`` (the ``keys`` alone)."""

    def __init__(self, device: torch.device, keys: Iterable[str]):
        self.device = torch.device(device)
        self.keys = tuple(keys)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Staged:
        host = {k: (None if batch.get(k) is None
                    else torch.from_numpy(np.ascontiguousarray(batch[k])))
                for k in self.keys}
        if self._stream is None:
            return Staged(host, None)
        with torch.cuda.stream(self._stream):
            dev = {k: (None if t is None else
                       t.pin_memory().to(self.device, non_blocking=True))
                   for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return Staged(dev, event)
