"""Logger and metric smoothing for the port's CLIs.

The port's own copy of ``relation_detr_tpu/utils/logging.py`` (the port
imports nothing of the JAX package): ``setup_logger`` (stdout and an
optional file), ``SmoothedValue`` (windowed median / average of a scalar
series) and ``MetricLogger`` (periodic progress lines over an iterable).
Values are plain floats. Under a process group only the main process
(rank 0) logs below warnings and writes a log file.
"""
from __future__ import annotations

import datetime
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Optional

from relation_detr_tpu_torch.parallel import mesh


def setup_logger(name: str = "relation_detr_tpu_torch", output: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    main = mesh.is_main()
    logger.setLevel(level if main else max(level, logging.WARNING))
    if logger.handlers:
        return logger
    logger.propagate = False
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s] %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output and main:
        os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
        fh = logging.FileHandler(output)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    """Windowed median/avg of a scalar series."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 50,
                 logger: Optional[logging.Logger] = None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq
        self.logger = logger or setup_logger()

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def log_every(self, iterable, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        total = len(iterable) if hasattr(iterable, "__len__") else None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_s))}  "
                meters = self.delimiter.join(
                    f"{name}: {meter}" for name, meter in self.meters.items()
                )
                self.logger.info(
                    f"{header} [{i}{'/' + str(total) if total else ''}]  {eta}"
                    f"{meters}  iter_t: {iter_time}  data_t: {data_time}"
                )
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.logger.info(f"{header} done in {datetime.timedelta(seconds=int(elapsed))}")
