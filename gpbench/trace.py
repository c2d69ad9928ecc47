"""The traced run: `torch.profiler` over the window, reduced in memory.

The window is one `record_function` span (`WINDOW`), so its bounds are on
the profiler's clock. From the device's events inside it come the busy
time (the union of their intervals), each kernel's launches and seconds by
name, and the idle gaps; a gap is put down to what the host was doing at
its midpoint: the innermost of the harness's layer spans (`gpbench:...`),
else the innermost host operation, else Python outside any operation.
Nothing is written to disk.
"""

from __future__ import annotations

import contextlib
import heapq
import importlib
from collections import defaultdict
from typing import NamedTuple

import torch

WINDOW = "gpbench:window"
SPAN = "gpbench:"


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    kernels: dict  # name -> [launches, seconds]
    idle_by_host: dict  # what the host did -> seconds of device idle


def _ns(e, which):
    f = getattr(e, f"{which}_ns", None)
    return f() if f is not None else 1000 * getattr(e, f"{which}_us")()


def _is_device(e):
    """A device activity: a kernel, copy or set, not the device-side copy
    of a host annotation such as the window's span."""
    return (str(e.device_type()).split(".")[-1] in ("CUDA", "PrivateUse1")
            and not e.name().startswith(SPAN) and not e.is_user_annotation())


def summarize(events) -> Summary:
    win = [e for e in events if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    t0 = _ns(win[0], "start")
    t1 = t0 + _ns(win[0], "duration")
    dev, host = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        s = _ns(e, "start")
        d = _ns(e, "duration")
        if _is_device(e):
            if s >= t1 or s + d <= t0:
                continue
            dev.append((max(s, t0), min(s + d, t1)))
            k = kernels[e.name()]
            k[0] += 1
            k[1] += d * 1e-9
        elif e.name() != WINDOW and s < t1 and s + d > t0:
            host.append((s, s + d, e.name()))
    dev.sort()
    busy, gaps, end = 0, [], t0
    for s, e in dev:
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if t1 > end:
        gaps.append((end, t1))
    # a sweep over the gaps' midpoints, keeping the host events open there
    idle = defaultdict(float)
    host.sort()
    open_, i = [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(open_, (host[i][1], host[i][0], host[i][2]))
            i += 1
        while open_ and open_[0][0] <= mid:
            heapq.heappop(open_)
        spans_ = [(e - s, n[len(SPAN):]) for e, s, n in open_ if n.startswith(SPAN)]
        ops = [(e - s, n) for e, s, n in open_ if not n.startswith(SPAN)]
        label = " / ".join(min(x)[1] for x in (spans_, ops) if x) or "python"
        idle[label] += (g1 - g0) * 1e-9
    return Summary(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9, kernels=dict(kernels),
                   idle_by_host=dict(idle))


@contextlib.contextmanager
def spans(table):
    """Wrap each `(module, attribute, layer)` of `table` in a
    `record_function` span named `gpbench:<layer>` for the block, so that
    the trace shows which layer the host was in."""
    saved = []
    try:
        for module, attr, layer in table:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, _spanned(fn, SPAN + layer))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _spanned(fn, name):
    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return call


def profiler():
    """A profiler of the host and, where there is one, the card."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof):
    return prof.profiler.kineto_results.events()
