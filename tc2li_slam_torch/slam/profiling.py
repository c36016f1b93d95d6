"""Per-stage timing statistics and the device trace (port of
``tc2li_slam_tpu/slam/profiling.py``).

- ``StageTimer``: named per-call samples with the reference's mean / std /
  max / total report. ``System`` builds it with ``enabled=cfg.profile``;
  disabled, it records nothing. On a CUDA device a sample is the device
  time between two CUDA events recorded around the stage on the current
  stream (first to last enqueued operation, idle gaps included), read
  without blocking once the events have completed; on the CPU it is the
  host clock.
- ``device_trace``: ``torch.profiler`` around a region, written as a Chrome
  trace JSON (chrome://tracing, Perfetto).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from collections import defaultdict
from pathlib import Path

import torch


class StageTimer:
    """Accumulates per-stage durations; prints a PrintTimeStats-style report."""

    def __init__(self, device: torch.device | str, enabled: bool = True):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.samples: dict[str, list[float]] = defaultdict(list)
        self._events: list[tuple[str, object, object]] = []   # pairs not yet read

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        if self.cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                yield
            finally:
                e1.record()
                self._events.append((name, e0, e1))
                # fold the finished pairs (query() does not block)
                while self._events and self._events[0][2].query():
                    self._fold()
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.samples[name].append(time.perf_counter() - t0)

    def _fold(self):
        name, e0, e1 = self._events.pop(0)
        self.samples[name].append(e0.elapsed_time(e1) * 1e-3)

    def add(self, name: str, seconds: float):
        if self.enabled:
            self.samples[name].append(seconds)

    def stats(self) -> dict[str, dict[str, float]]:
        """{stage: {"n", "mean_ms", "std_ms" (population), "max_ms",
        "total_s"}}; on a CUDA device one synchronize when events are
        pending."""
        if self._events:
            torch.cuda.synchronize()
            while self._events:
                self._fold()
        out = {}
        for name, xs in self.samples.items():
            n = len(xs)
            mean = sum(xs) / n
            var = sum((x - mean) ** 2 for x in xs) / n if n > 1 else 0.0
            out[name] = {
                "n": n,
                "mean_ms": mean * 1e3,
                "std_ms": math.sqrt(var) * 1e3,
                "max_ms": max(xs) * 1e3,
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        """Formatted table (the PrintTimeStats analog)."""
        lines = [f"{'stage':<24}{'n':>6}{'mean ms':>10}{'std':>8}{'max':>9}{'total s':>9}"]
        for name, s in sorted(self.stats().items()):
            lines.append(
                f"{name:<24}{s['n']:>6}{s['mean_ms']:>10.2f}{s['std_ms']:>8.2f}"
                f"{s['max_ms']:>9.1f}{s['total_s']:>9.2f}"
            )
        return "\n".join(lines)

    def reset(self):
        self._events.clear()
        self.samples.clear()


@contextlib.contextmanager
def device_trace(log_dir: str | os.PathLike, device: torch.device | str):
    """``torch.profiler`` over the enclosed region: host activity, and the
    card's when ``device`` is CUDA. Yields the path of the Chrome trace JSON
    that is written into ``log_dir`` on exit.

    The profiler warms up for one step before the region (a launch, waited
    for, on a CUDA device) and records the region as its one active step:
    a trace started cold lost the card's records of the region's first
    kernels once in several runs on an H100 (the host's launches were there)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        if cuda:
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)
        prof.step()   # the region is the active step
        yield path
        prof.step()
