"""Console+file logger and wall-clock timer (counterpart of
exavatar_release_tpu/utils/logging.py).

Equivalent of the reference's colorlogger + Timer (reference
avatar/common/logger.py:19-52, avatar/common/timer.py:10-38, including the
10-iteration warmup before the average starts accumulating).
"""
from __future__ import annotations

import logging
import os
import os.path as osp
import time


def make_logger(log_dir: str, log_name: str = "logs.txt",
                name: str = "exavatar") -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    # one logger per file: a second run in the same process writes its own log
    logger = logging.getLogger(f"{name}:{osp.abspath(osp.join(log_dir, log_name))}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s",
                                "%m-%d %H:%M:%S")
        fh = logging.FileHandler(osp.join(log_dir, log_name))
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger


class Timer:
    """Wall-clock average with warmup (reference timer.py:10-38: the first
    ``warmup`` tocs don't count toward the average)."""

    def __init__(self, warmup: int = 10):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0
        self.warm_cnt = 0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True) -> float:
        self.diff = time.perf_counter() - self.start_time
        if self.warm_cnt < self.warmup:
            self.warm_cnt += 1
            return self.diff
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff
