"""Windowed metric meters and timed iteration logging; the port's copy of
the JAX ``engine/logging.py``."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = "", total: int | None = None):
        i = 0
        if total is None:
            try:
                total = len(iterable)
            except TypeError:
                total = -1
        start_time = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % print_freq == 0 or i == total - 1):
                eta = iter_time.global_avg * (total - i) if total > 0 else 0
                print(f"{header} [{i}/{total}] eta: {datetime.timedelta(seconds=int(eta))} "
                      f"{self} iter_time: {iter_time} data_time: {data_time}", flush=True)
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        if print_freq:
            print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))} "
                  f"({total_time / max(i, 1):.4f} s / it)", flush=True)
