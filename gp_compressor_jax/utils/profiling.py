"""Profiling and structured logging.

The reference's only observability is printf (SURVEY.md §5: "Tracing /
profiling: none"). Here: phase timers that wait for the device
(`jax.block_until_ready` — JAX returns before the device finishes, so a
timer without it measures the enqueue), an optional JAX profiler trace
context, and JSONL metric logging.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Callable, Dict, Optional

import jax


class PhaseTimer:
    """Accumulates per-phase wall times with device sync at boundaries.

    with timer.phase("train", outputs=lambda: state): ...
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[Callable[[], Any]] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync())
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.times.items()}


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """JAX profiler trace (TensorBoard/XProf) when logdir is given."""
    if logdir:
        with jax.profiler.trace(logdir):
            yield
    else:
        yield


class MetricLogger:
    """Append-only JSONL metrics (the reference prints scalars to stdout —
    SURVEY.md §5 'Metrics / logging: printed scalars only')."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def log(self, **metrics):
        rec = {"t": round(time.time(), 3), **{
            k: (float(v) if hasattr(v, "dtype") else v)
            for k, v in metrics.items()}}
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
