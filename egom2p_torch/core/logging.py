"""Metric logging: smoothed console meters and per-epoch JSON lines.

Copy of egom2p_tpu/core/logging.py's SmoothedValue, MetricLogger and
JsonlLogger (reference: egom2p/utils/logger.py:20-182,
run_training_egom2p.py:669-671), for one process.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    def __str__(self):
        return f"{self.median:.4f} ({self.global_avg:.4f})"


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 10):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def log_every(self, iterable, header: str = "", total: Optional[int] = None):
        """Yields (i, item); prints the meters every print_freq items."""
        i = 0
        iter_time, data_time = SmoothedValue(), SmoothedValue()
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield i, obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % self.print_freq == 0:
                meters = self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())
                eta = ""
                if total:
                    remain = (total - i - 1) * iter_time.global_avg
                    eta = f"eta: {datetime.timedelta(seconds=int(remain))}  "
                print(f"{header} [{i}{f'/{total}' if total else ''}]  {eta}"
                      f"{meters}  time: {iter_time}  data: {data_time}", flush=True)
            i += 1
            if total is not None and i >= total:
                break


class JsonlLogger:
    """Per-epoch JSON lines, like the reference's log.txt."""

    def __init__(self, output_dir: str, filename: str = "log.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)

    def write(self, record: Dict):
        with open(self.path, "a") as f:
            f.write(json.dumps({k: (float(v) if hasattr(v, "item") else v)
                                for k, v in record.items()}) + "\n")
