"""Tracing / profiling helpers.

The reference's only instrumentation is wall-clock around Match()
(MatchToolDlg.cpp:783,1072; chrono in src/TemplateMatcher.cpp:117,402).
This library provides: stage timers (host wall-clock with device sync),
a jax.profiler trace context for TensorBoard-style device traces, and a
simple structured event log.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

import jax


class StageTimer:
    """Collects named stage durations (device-synchronized)."""

    def __init__(self):
        self.events: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            self.events.append({
                "stage": name,
                "ms": (time.perf_counter() - t0) * 1000.0,
                "t": time.time(),
            })

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.events:
            out[e["stage"]] = out.get(e["stage"], 0.0) + e["ms"]
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.events, f, indent=1)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """jax.profiler trace context; no-op when trace_dir is None."""
    if trace_dir is None:
        yield
        return
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
