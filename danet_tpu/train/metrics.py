"""Metrics / observability: TensorBoard scalars + structured JSONL + timing.

Replaces the reference's tf.summary scalar flow
(/root/reference/main.py:343-351,404,433-436): same scalars (train/valid
loss, SNR, LR) under the same SUMMARY_DIR/"<timestamp> <SUMMARY_TITLE>"
run-dir convention, written via tensorboardX, plus a structured JSONL
stream (one record per step/epoch) and per-step wall-clock timing — the
profiling the reference lacks (SURVEY.md §5).
"""
from __future__ import annotations

import datetime
import json
import os
import sys
import time
from typing import Optional


class MetricsWriter:
    def __init__(self, summary_dir: str, title: str,
                 tensorboard: bool = True):
        stamp = datetime.datetime.now().strftime("%m%d_%H%M%S")
        self.run_dir = os.path.join(summary_dir, "%s %s" % (stamp, title))
        os.makedirs(self.run_dir, exist_ok=True)
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                sys.stderr.write("tensorboardX is not installed: metrics go "
                                 "to metrics.jsonl only\n")
            else:
                self._tb = SummaryWriter(self.run_dir)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        rec = {"step": int(step), "t": time.time()}
        for k, v in values.items():
            v = float(v)
            rec["%s/%s" % (prefix, k)] = v
            if self._tb is not None:
                self._tb.add_scalar("%s/%s" % (prefix, k), v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()


class StepTimer:
    """Rolling per-step wall-clock timing (steps/sec, mixtures/sec)."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.total = 0.0
        self.count = 0

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self.t0
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
