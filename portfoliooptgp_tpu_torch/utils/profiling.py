"""Profiling hooks: a `torch.profiler` trace, the program's spans and a
step timer.

Port of portfoliooptgp_tpu/utils/profiling.py. Where the JAX package
captures an XPlane trace for TensorBoard, `trace` records host and CUDA
activity with `torch.profiler` and writes a Chrome trace (viewable in
Perfetto or chrome://tracing) into LOGDIR, with the table of the
program's spans beside it.

`span(name)` marks a stage of the program (names `<layer>.<stage>`, e.g.
`lbfgs.iteration`, `nuts.leaf`). While a profiler runs it is a host range
of the profiler's trace, on its clock, and adds to `SPANS[name] = [count,
total_ns, self_ns]`, self time being the duration less that of the spans
opened inside it on the same thread. The range is `_RecordFunctionFast`'s:
a host-only range that costs about a tenth of a `record_function`, which
enters an operator of its own and leaves a copy of itself on the device's
timeline. With no profiler running a span records nothing: a flag read
and a shared null context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time

import torch

from portfoliooptgp_tpu_torch import params

#: {span name: [count, total_ns, self_ns]}, filled while a profiler runs.
SPANS: dict = {}
_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Open(threading.local):
    """The spans open on this thread: autograd runs a CUDA backward on a
    thread of its own, whose spans are no children of the caller's."""

    def __init__(self):
        self.stack = []


_OPEN = _Open()


class _Span:
    __slots__ = ("name", "range", "t0", "children")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _OPEN.stack.append(self)
        self.children = 0
        self.t0 = time.perf_counter_ns()
        self.range = _Range(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        stack = _OPEN.stack
        stack.pop()
        if stack:
            stack[-1].children += ns
        with _LOCK:
            row = SPANS.setdefault(self.name, [0, 0, 0])
            row[0] += 1
            row[1] += ns
            row[2] += ns - self.children
        return False


def span(name: str):
    """A context manager that marks the block as the stage `name` while a
    profiler runs, and does nothing otherwise."""
    return _Span(name) if _enabled() else _OFF


def reset_spans() -> None:
    """Empty `SPANS`."""
    with _LOCK:
        SPANS.clear()


def spans_table() -> dict:
    """`SPANS` in milliseconds: {name: {"count", "total_ms", "self_ms"}}."""
    with _LOCK:
        rows = {k: list(v) for k, v in SPANS.items()}
    return {k: {"count": n, "total_ms": t * 1e-6, "self_ms": s * 1e-6}
            for k, (n, t, s) in sorted(rows.items())}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write `<logdir>/trace.json`, and the spans
    the block recorded as `<logdir>/spans.json` (`spans_table`); CUDA
    activity is recorded when a GPU is present."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    reset_spans()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump(spans_table(), f, indent=1)


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
