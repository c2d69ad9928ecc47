"""Profiling hooks: a `torch.profiler` trace and a step timer.

Port of portfoliooptgp_tpu/utils/profiling.py. Where the JAX package
captures an XPlane trace for TensorBoard, `trace` records host and CUDA
activity with `torch.profiler` and writes a Chrome trace (viewable in
Perfetto or chrome://tracing) into LOGDIR.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write `<logdir>/trace.json`; CUDA activity is
    recorded when a GPU is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step timer for steps/s metrics. A step that puts a tensor
    under `out["result"]` is timed up to its device's completion: CUDA
    runs asynchronously, so the timer synchronizes that device first."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        out = {}
        yield out
        result = out.get("result")
        if isinstance(result, torch.Tensor) and result.device.type == "cuda":
            torch.cuda.synchronize(result.device)
        self.times.append(time.perf_counter() - t0)

    @property
    def mean_s(self):
        return sum(self.times) / max(len(self.times), 1)

    def steps_per_s(self):
        return 1.0 / self.mean_s if self.times else 0.0
