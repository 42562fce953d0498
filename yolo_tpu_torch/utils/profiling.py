"""Tracing and timing hooks (port of yolo_tpu/utils/profiling.py):
torch.profiler traces behind a flag, a timing recipe that waits for the
card, and a phase timer."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def synchronize() -> None:
    """Wait for the card's queued work (nothing to wait for without
    one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(f, *args, n: int = 15) -> float:
    """Mean wall-clock ms a call: one warm-up call, then n timed calls
    between two synchronizations."""
    f(*args)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        f(*args)
    synchronize()
    return (time.perf_counter() - t0) / n * 1e3


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]):
    """``with maybe_trace(dir):`` writes a Chrome trace (trace.json,
    CPU and, where a card is present, CUDA activity) into ``dir``; no-op
    without a directory."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))



class PhaseTimer:
    """Wall-clock phase timing that waits for the card at each phase's
    end."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        synchronize()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
