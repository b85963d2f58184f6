"""Host->device prefetch pipeline (the port's copy of
``tpuseg/data/prefetch.py``, in PyTorch's idiom).

A bounded background thread builds host batch i+1 (decode, augmentation)
and uploads it while the device computes batch i. The upload goes through
pinned host memory with ``non_blocking=True`` on a side CUDA stream; the
consumer's stream waits on an event recorded after the copies, and each
tensor is marked as used by the consumer's stream (``record_stream``) so
that the caching allocator does not hand its memory back to the side
stream early.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


def _map(fn, tree):
    """``fn`` on every numpy array or tensor of a nest of dicts, lists and
    tuples; anything else passes through."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


class DevicePrefetcher:
    """Iterate device-resident batches with decode+upload run ahead.

    load_fn(i) -> host batch (numpy arrays or tensors, in dicts, lists and
    tuples) for step i; the prefetch thread calls it, then uploads the
    result to ``device``, keeping up to ``depth`` uploaded batches ready.
    On the CPU the batch comes back as tensors on the host. Exceptions in
    load_fn propagate to the consumer at the next __next__().
    """

    _END = object()

    def __init__(self, load_fn: Callable[[int], object], n_batches: int,
                 depth: int = 2, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: list[BaseException] = []
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None

        def upload(a):
            t = (torch.from_numpy(np.ascontiguousarray(a))
                 if isinstance(a, np.ndarray) else a)
            if not cuda:
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

        def worker():
            try:
                for i in range(n_batches):
                    host = load_fn(i)
                    if cuda:
                        with torch.cuda.stream(stream):
                            dev = _map(upload, host)
                            event = torch.cuda.Event()
                            event.record(stream)
                    else:
                        dev, event = _map(upload, host), None
                    self._q.put((dev, event))
            except BaseException as e:  # surfaced in __next__
                self._err.append(e)
            finally:
                self._q.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._thread.join()
            if self._err:
                raise self._err[0]
            raise StopIteration
        batch, event = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            _map(lambda t: t.record_stream(current), batch)
        return batch
