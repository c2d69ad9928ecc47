"""Profiling hooks: a `torch.profiler` trace and a step timer.

Port of portfoliooptgp_tpu/utils/profiling.py. Where the JAX package
captures an XPlane trace for TensorBoard, `trace` records host and CUDA
activity with `torch.profiler` and writes a Chrome trace (viewable in
Perfetto or chrome://tracing) into LOGDIR.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from portfoliooptgp_tpu_torch import params


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


def _tensors(tree):
    """Every tensor in a result: tensors, tuples, lists, dicts and the
    port's model dataclasses (through `params.tree_leaves`)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for leaf in params.tree_leaves(tree):
            yield from _tensors(leaf)


def block_until_ready(tree):
    """Wait for every CUDA device that holds a tensor of `tree`, once per
    device: the counterpart of `jax.block_until_ready` on a pytree."""
    devices = {t.device for t in _tensors(tree) if t.device.type == "cuda"}
    for device in sorted(devices, key=str):
        torch.cuda.synchronize(device)
    return tree


class StepTimer:
    """Wall-clock step timer for steps/s metrics. Whatever a step puts
    under `out["result"]` (a tensor, a tuple such as `(state, loss)`, a
    model tree) is timed up to the completion of every device holding
    one of its tensors: CUDA runs asynchronously."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self, result_getter=None):
        """`result_getter` is accepted, and unused, as in the JAX package."""
        t0 = time.perf_counter()
        out = {}
        yield out
        if "result" in out:
            block_until_ready(out["result"])
        self.times.append(time.perf_counter() - t0)

    @property
    def mean_s(self):
        return sum(self.times) / max(len(self.times), 1)

    def steps_per_s(self):
        return 1.0 / self.mean_s if self.times else 0.0
