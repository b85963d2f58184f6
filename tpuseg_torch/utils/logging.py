"""Training log utilities (port of ``tpuseg/utils/logging.py``; Yolact
``utils/{functions, logger}.py``): :class:`MovingAverage` for the loss-term
console lines, :class:`ProgressBar`, and a structured json-lines
:class:`Log`."""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque


class MovingAverage:
    """Sliding-window average of finite values (``functions.py``)."""

    def __init__(self, max_window_size: int = 1000):
        self.max_window_size = max_window_size
        self.window = deque()
        self.sum = 0.0

    def add(self, elem: float) -> None:
        # a single inf would turn the running sum into NaN for good once
        # it left the window, so non-finite values are dropped, as upstream
        if math.isfinite(elem):
            self.window.append(elem)
            self.sum += elem
            if len(self.window) > self.max_window_size:
                self.sum -= self.window.popleft()

    def append(self, elem: float) -> None:
        self.add(elem)

    def get_avg(self) -> float:
        return self.sum / max(len(self.window), 1)

    def __len__(self) -> int:
        return len(self.window)


class ProgressBar:
    """Console progress bar (``functions.py::ProgressBar``)."""

    def __init__(self, length: int, max_val: int):
        self.max_val = max_val
        self.length = length
        self.cur_val = 0

    def set_val(self, new_val: int) -> None:
        self.cur_val = min(new_val, self.max_val)

    def __repr__(self) -> str:
        frac = self.cur_val / max(self.max_val, 1)
        done = int(round(self.length * frac))
        return "█" * done + "░" * (self.length - done)


class Log:
    """Structured per-iteration training log (``logger.py::Log``): one
    json object per line in ``<log_dir>/<log_name>.log``, stamped with the
    session's start."""

    def __init__(self, log_name: str, log_dir: str = "logs/",
                 overwrite: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{log_name}.log")
        if overwrite and os.path.exists(self.path):
            os.remove(self.path)
        self.session = int(time.time())

    def log(self, type_: str, data: dict | None = None, **kwargs) -> None:
        entry = {"type": type_, "session": self.session, "time": time.time(),
                 "data": {**data, **kwargs} if data else kwargs}
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
