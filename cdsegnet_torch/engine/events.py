"""Scalar metric storage (reference `pointcept/utils/events.py:293-593`).

Own copy of `cdsegnet_tpu/engine/events.py`.

`EventStorage` keeps smoothed scalar histories; writers emit JSON lines
(a tensorboard-free equivalent of the reference's TB writer — traces and
scalars land in the experiment dir as `metrics.jsonl`).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class HistoryBuffer:
    def __init__(self, window: int = 20):
        self._window = deque(maxlen=window)
        self._total = 0.0
        self._count = 0
        self.latest = 0.0

    def update(self, value: float):
        value = float(value)
        self._window.append(value)
        self._total += value
        self._count += 1
        self.latest = value

    def median(self) -> float:
        s = sorted(self._window)
        return s[len(s) // 2] if s else 0.0

    def avg(self) -> float:
        return sum(self._window) / max(len(self._window), 1)

    def global_avg(self) -> float:
        return self._total / max(self._count, 1)


class EventStorage:
    """JSONL metrics + optional TensorBoard event files (reference
    `TensorboardXWriter`; our writer is `utils/tbwriter.py`)."""

    def __init__(self, output_dir: Optional[str] = None, tensorboard: bool = True):
        self.histories: Dict[str, HistoryBuffer] = defaultdict(HistoryBuffer)
        self.step = 0
        self._file = None
        self._tb = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(os.path.join(output_dir, "metrics.jsonl"), "a")
            if tensorboard:
                from cdsegnet_torch.utils.tbwriter import TBWriter

                self._tb = TBWriter(os.path.join(output_dir, "tb"))

    def put_scalar(self, name: str, value: float):
        self.histories[name].update(value)

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def write(self, step: Optional[int] = None):
        step = step if step is not None else self.step
        if self._file is None:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: h.latest for k, h in self.histories.items()})
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._tb is not None:
            for k, h in self.histories.items():
                self._tb.add_scalar(k, h.latest, step)

    def close(self):
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
