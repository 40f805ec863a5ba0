"""Tracing / profiling hooks (SURVEY.md §5.1 — absent in the reference).

- :class:`StageTimer` — lightweight per-stage wall-clock + throughput counters
  that end each stage in ``jax.block_until_ready``, suitable for production
  telemetry of the frame pipeline (the reference had only tqdm progress bars).
- :func:`trace` — context manager around ``jax.profiler`` emitting an XPlane
  trace directory viewable in TensorBoard/Perfetto, for kernel-level analysis.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax

from mmwave_radar_processing_jax.utils.logger import get_logger


class StageTimer:
    """Accumulates wall-clock and item counts per named pipeline stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 1, block_on=None):
        """Time one stage execution; pass the stage output via ``block_on``
        (or the yielded sink) so the clock stops when the device is done."""
        t0 = time.perf_counter()
        holder = {}

        def sink(value):
            holder["out"] = value
            return value

        yield sink
        if "out" in holder and holder["out"] is not None:
            jax.block_until_ready(holder["out"])
        elif block_on is not None:
            jax.block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.items[name] += items

    def report(self) -> str:
        lines = ["stage                     total_s   calls  items   items/s"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            items = self.items[name]
            rate = items / tot if tot > 0 else 0.0
            lines.append(
                f"{name:<24} {tot:8.3f} {self.counts[name]:7d} {items:6d} {rate:9.1f}"
            )
        return "\n".join(lines)

    def log_report(self) -> None:
        get_logger(__name__).info("pipeline timing:\n%s", self.report())

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.items.clear()


@contextlib.contextmanager
def trace(log_dir: str, host_tracer_level: int = 2):
    """``jax.profiler`` trace context: writes an XPlane trace to ``log_dir``."""
    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        get_logger(__name__).info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline (``jax.profiler.TraceAnnotation``)."""
    with jax.profiler.TraceAnnotation(name):
        yield
