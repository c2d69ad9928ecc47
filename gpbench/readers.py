"""Arithmetic shared by the metric readers of `gpbench/metrics/`.

Each returns None where the run holds nothing to read (no trace, no card's
counters, no unit of that kind), and the harness then leaves the metric out.
"""

from __future__ import annotations

from gpbench import costs

CLUSTER = "stationary_nll_cluster_kernel"


def rate(run, unit):
    """Units of work done per second of the window: the units finished in
    it and the share of the last unit that fell inside it."""
    n = run.work.get(unit)
    return None if n is None else n / run.seconds


def per(run, counter, unit):
    """A counter's count per unit of work ("steps": calls or transitions),
    over the finished units, the last one whole."""
    c, n = run.counters.get(counter), run.units.get(unit)
    return None if c is None or not n else c / n


def host_ms_per(run, counter):
    """Milliseconds of the traced window in which the device was idle,
    per count of `counter`."""
    c = run.counters.get(counter)
    if run.trace is None or not c:
        return None
    return 1e3 * (run.trace.window_s - run.trace.busy_s) / c


def idle_pct(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def _cluster_launches(run):
    """{with_inverse: (launches, seconds)} of the cluster kernel's two
    instances in the trace (`<true>` forms W for the gradient)."""
    out = {}
    for name, (n, s) in (run.trace.kernels.items() if run.trace else ()):
        if CLUSTER in name:
            w = "<true>" in name
            a, b = out.get(w, (0, 0.0))
            out[w] = (a + n, b + s)
    return out


def roofline_pct(run):
    """The least time of the cluster kernel's launches (`costs.nll_bound_ms`
    of the cell's shape, per variant) over their traced time."""
    launches = _cluster_launches(run)
    seconds = sum(s for _, s in launches.values())
    if seconds <= 0:
        return None
    bound = sum(n * costs.nll_bound_ms(with_inverse=w, **run.shape)[0] * 1e-3
                for w, (n, _) in launches.items())
    return 100.0 * bound / seconds


def step_mfu_pct(run):
    """The operations the window's NLL evaluations need (`costs.nll_flops`
    per variant, counted from the traced launches) over the traced window
    at the fp32 peak."""
    launches = _cluster_launches(run)
    if not launches:
        return None
    s = run.shape
    flops = sum(n * costs.nll_flops(s["B"], s["N"], s["J"], s["JD"], with_gradient=w)
                for w, (n, _) in launches.items())
    return 100.0 * flops / run.trace.window_s / costs.PEAK_FP32_FLOPS
