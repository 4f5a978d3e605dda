"""Structured per-step metrics: a JSONL file and a stdout summary, with the
edges/s throughput counter.

A copy of ``fieldconv_tpu/train/metrics.py`` (which has no JAX in it, but
its package imports JAX).
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, window: int = 10,
                 print_every: int = 25):
        self.path = path
        self.window = deque(maxlen=window)
        self.print_every = print_every
        self.step = 0
        self._fh = open(path, "a") if path else None
        self._t_last = time.perf_counter()

    def log(self, metrics: dict, edges: Optional[float] = None,
            t: Optional[float] = None) -> None:
        """t: perf_counter timestamp of when the step was issued — pass it
        when logging is deferred (chunked readback) so step timing reflects
        the actual step cadence, not the flush cadence."""
        now = time.perf_counter() if t is None else t
        dt = now - self._t_last
        self._t_last = now
        self.step += 1
        rec = {"step": self.step, "step_time_s": round(dt, 5)}
        rec.update({k: float(v) for k, v in metrics.items()})
        if edges:
            rec["edges_per_s"] = round(edges / max(dt, 1e-9))
        if "loss" in rec:
            self.window.append(rec["loss"])
            rec["loss_window"] = round(sum(self.window) / len(self.window), 5)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.step % self.print_every == 0:
            msg = " ".join(f"{k}={v}" for k, v in rec.items())
            print(msg, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
