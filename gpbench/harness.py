"""The benchmark's harness, driven by data.

`BENCHMARK.json` at the root names the cells, their configurations and
traffic, and the metrics. Everything else is found by name under
`gpbench/`:

- `configs/<file>` (the configuration's `file`): the configuration, whose
  `kind` names the module `kinds/<kind>.py` that sets a cell up and runs
  one unit of its work;
- `workloads/<traffic>.json`: the traffic's parameters;
- `limits/<cell>.json`: each number the check compares, with its limit;
- `metrics/<metric>.py`: a reader, `read(run) -> float | None`, of one
  metric from a finished run (`Run`); None leaves the metric out.

A later cell, traffic, configuration of a known kind or metric is a new
file and a new entry in `BENCHMARK.json`; no file here changes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from typing import NamedTuple, Optional

import torch

from gpbench import trace as trace_mod

# top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "portfoliooptgp_tpu")


class Run(NamedTuple):
    """What the metric readers get from a finished run."""

    cell: str
    setup_s: float
    seconds: float  # the window
    work: dict  # the cell's unit (e.g. "forecasts") done in the window
    units: dict  # the unit and "steps" finished, the last one's overrun too
    counters: dict  # counter deltas over the same (empty off the card)
    trace: Optional[trace_mod.Summary]  # the traced window, or None
    shape: dict  # the fused NLL's operands of one evaluation (costs.py)


class Spec(NamedTuple):
    root: str
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # BENCHMARK.json metric entries this run reports


def _load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root, workload, traced: bool) -> Spec:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = os.path.join(root, "gpbench")
    kind = "per_layer" if traced else "end_to_end"
    metrics = [m for m in bench[kind] if workload in m.get("workloads", [workload])]
    return Spec(root, _json(os.path.join(root, cfg["file"])),
                _json(os.path.join(here, "workloads", w["traffic"] + ".json")),
                _json(os.path.join(here, "limits", workload + ".json")), metrics)


def kind_module(spec: Spec):
    kind = spec.config["kind"]
    return _load_module(os.path.join(spec.root, "gpbench", "kinds", kind + ".py"),
                        f"gpbench_kind_{kind}")


def read_metric(spec: Spec, name: str, run: Run):
    path = os.path.join(spec.root, "gpbench", "metrics", name + ".py")
    return _load_module(path, "gpbench_metric_" + name.replace(".", "_")).read(run)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell, device, seconds, traced, spans=()):
    """Run units of the cell's work back to back for `seconds`, finishing
    the unit in progress at the close. Returns (work, units, steps,
    counter deltas, trace summary or None): `work` counts the units
    finished inside the window and, of the unit in progress at its close,
    the share of that unit's time that fell inside it, so it is the work of
    exactly `seconds` however the window cuts the last unit; `units`,
    `steps` and the counters take in the last unit whole."""
    c0 = cell.counters()
    work, units, steps = 0.0, 0, 0
    prof = trace_mod.profiler() if traced else None
    with contextlib.ExitStack() as stack:
        if traced:
            stack.enter_context(trace_mod.spans(spans))
            prof.start()
            stack.callback(prof.stop)
            _reset_program_spans()
            stack.enter_context(torch.profiler.record_function(trace_mod.WINDOW))
        t0 = time.perf_counter()
        before = 0.0
        while True:
            n = cell.step()
            _sync(device)
            now = time.perf_counter() - t0
            units += n
            steps += 1
            if now >= seconds:
                work += n * (seconds - before) / (now - before)
                break
            work += n
            before = now
    c1 = cell.counters()
    summary = trace_mod.summarize(trace_mod.events(prof)) if traced else None
    return work, units, steps, {k: c1[k] - c0[k] for k in c1}, summary


def _reset_program_spans():
    """Empty the program's span table (`profiling.SPANS`, filled only while
    a profiler runs), so that its counts cover this traced window alone."""
    profiling = sys.modules.get("portfoliooptgp_tpu_torch.utils.profiling")
    if profiling is not None:
        profiling.reset_spans()


def check(cell, limits, control=None, nan=float("inf")):
    """{name: (reading, limit)} of the program's outputs, or with
    `control` (a reference precision) of that control in their place;
    `nan` is what a value that is not a number reads as."""
    readings = all_readings(cell, control, nan)
    return {name: (readings[name], limits[name]) for name in limits}


def all_readings(cell, control=None, nan=float("inf")) -> dict:
    """Every number the cell reads from its outputs (or the control's),
    those its limits compare and those it keeps for the record."""
    out = cell.outputs() if control is None else cell.control_outputs(control)
    return cell.readings(out, nan)


def passed(checks) -> bool:
    return all(v <= lim for v, lim in checks.values())


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(root, workload, seed, seconds, traced, device, t_start):
    """One run of a cell: set-up, the window, the check. Returns the
    result line's object and the checks."""
    spec = load_spec(root, workload, traced)
    kind = kind_module(spec)
    cell = kind.Cell(spec.config, spec.traffic, seed % (1 << 63), device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    work, units, steps, counters, summary = measure(
        cell, device, seconds, traced, getattr(kind, "SPANS", ()))
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted, failed = cell.attempted_failed()
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = check(cell, spec.limits)
    run = Run(workload, setup_s, seconds, {kind.UNIT: work}, {kind.UNIT: units, "steps": steps},
              counters, summary, cell.shape)
    metrics = {}
    for m in spec.metrics:
        v = read_metric(spec, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": passed(checks) and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        top = sorted(summary.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v[1]] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result

