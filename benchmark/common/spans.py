"""The harness's spans around the port's module-level functions that an
entry point calls: host-clock start and end, the step or request they
belong to, and in a traced run a ``record_function`` range named
``bench/<span>`` so that the trace's idle gaps can be named by them. A
span marked ``sync`` ends with ``torch.cuda.synchronize()``, in the traced
run only, so that it measures the device's work too."""
from __future__ import annotations

import contextlib
import functools
import time

import torch


class Spans:
    def __init__(self, sync_ok: bool):
        self.sync_ok = sync_ok
        self.records = {}  # name -> [(start, end, item)]
        self.item = 0  # the step or request the next span belongs to
        self._undo = []

    def wrap(self, owner, attr: str, name: str, sync: bool = False) -> None:
        fn = getattr(owner, attr)
        rec = self.records.setdefault(name, [])
        sync = sync and self.sync_ok

        @functools.wraps(fn)
        def run(*args, **kwargs):
            item = self.item
            with torch.profiler.record_function(f"bench/{name}"):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                rec.append((t0, time.perf_counter(), item))
            return out

        setattr(owner, attr, run)
        self._undo.append((owner, attr, fn))

    @contextlib.contextmanager
    def span(self, name: str):
        rec = self.records.setdefault(name, [])
        item = self.item
        with torch.profiler.record_function(f"bench/{name}"):
            t0 = time.perf_counter()
            yield
            rec.append((t0, time.perf_counter(), item))

    def patch(self, owner, attr: str, make) -> None:
        """Replace ``owner.attr`` by ``make(original)`` until restore."""
        fn = getattr(owner, attr)
        setattr(owner, attr, make(fn))
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def per_item(self, name: str, lo: float, hi: float) -> dict:
        """Seconds of span ``name`` per item, over spans starting in
        [lo, hi)."""
        out = {}
        for t0, t1, item in self.records.get(name, []):
            if lo <= t0 < hi:
                out[item] = out.get(item, 0.0) + (t1 - t0)
        return out

