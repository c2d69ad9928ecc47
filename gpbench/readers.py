"""Arithmetic shared by the metric readers of `gpbench/metrics/`.

Each returns None where the run holds nothing to read (no trace, no card's
counters, no unit of that kind), and the harness then leaves the metric out.
"""

from __future__ import annotations

from gpbench import costs

CLUSTER = "stationary_nll_cluster_kernel"
PANEL = "blocked_panel_kernel"
PANEL_WIDTH = 128  # columns of a panel of the blocked tier


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


def _kernel(run, name):
    """(launches, seconds) of the traced kernels whose name holds `name`."""
    found = [v for k, v in (run.trace.kernels.items() if run.trace else ()) if name in k]
    return sum(n for n, _ in found), sum(s for _, s in found)


def panel_roofline_pct(run):
    """The least time of the panel kernel's launches over their traced time.
    An evaluation of the blocked factor at N launches one panel of each
    height N − 128k, k < ⌈N/128⌉, at the cell's batch B, so the launches
    over ⌈N/128⌉ count the evaluations, and each evaluation's least time
    is Σₖ `costs.panel_bound_ms(N − 128k, B)`."""
    n, seconds = _kernel(run, PANEL)
    if not n or seconds <= 0:
        return None
    B, N = run.shape["B"], run.shape["N"]
    heights = range(N, 0, -PANEL_WIDTH)
    per_eval = sum(costs.panel_bound_ms(nt, B)[0] for nt in heights) * 1e-3
    return 100.0 * n / len(heights) * per_eval / seconds


def evaluations(spans):
    """(value-only, with gradient) NLL evaluations of the optimizer: the
    counts of the program's spans `lbfgs.value` and `lbfgs.gradient`, or
    None where it recorded neither."""
    value, grad = spans.get("lbfgs.value"), spans.get("lbfgs.gradient")
    if not value and not grad:
        return None
    return (value[0] if value else 0), (grad[0] if grad else 0)


def evals_per(run, spans, unit):
    """The optimizer's NLL evaluations, value-only and with gradient, per
    unit of work (the last unit whole, as the spans count it)."""
    evals, n = evaluations(spans), run.units.get(unit)
    return None if evals is None or not n else sum(evals) / n


def span_mfu_pct(run, spans):
    """The operations of the window's NLL evaluations at the cell's shape
    (`costs.nll_flops`, counted by the optimizer's spans, whatever tier or
    kernel computes them) over the traced window at the fp32 peak; None
    where no operation ran on a device."""
    evals = evaluations(spans)
    if evals is None or run.trace is None or run.trace.busy_s <= 0:
        return None
    s = run.shape
    flops = sum(n * costs.nll_flops(s["B"], s["N"], s["J"], s["JD"], with_gradient=w)
                for n, w in zip(evals, (False, True)))
    return 100.0 * flops / run.trace.window_s / costs.PEAK_FP32_FLOPS
