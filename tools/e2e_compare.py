"""Time the 5-asset workflow (chip_smoke.run_workflow: step 4 and the
portfolio stage) of one or more checkouts on the card, in turns.

    python tools/e2e_compare.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (`.`, or another commit unpacked by
`git archive` into a directory that .gitignore lists, `build/parent` say)
and runs in a process of its own with its `portfoliooptgp_tpu_torch`
first on the path, as tools/dense_compare.py runs them: a cold run on
`make_market`, then three warm runs, each with its step-4 and portfolio
seconds. Name the roots in turns (parent, change, change, parent) to
compare two commits on one card.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "tools"))

from dense_compare import run_in_turns  # noqa: E402


def times_of(root: str) -> dict:
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import portfoliooptgp_tpu_torch
    from benchmarks.bench_portfolio_e2e import make_market

    if not torch.cuda.is_available():
        raise SystemExit("e2e_compare: needs a CUDA device")
    if not os.path.abspath(portfoliooptgp_tpu_torch.__file__).startswith(
            os.path.abspath(root) + os.sep):
        raise SystemExit(f"e2e_compare: imported {portfoliooptgp_tpu_torch.__file__}, "
                         f"not {root}'s")
    with tempfile.TemporaryDirectory() as data:
        make_market(data)
        t0 = time.perf_counter()
        cs.run_workflow(data, "cuda")
        out = dict(cold_s=time.perf_counter() - t0, warm=[])
        for _ in range(3):
            stages = {}
            wall, _ = cs.run_workflow(data, "cuda", timings=stages)
            out["warm"].append(dict(wall_s=wall, **stages))
    return out


if __name__ == "__main__":
    sys.exit(run_in_turns(__file__, times_of, sys.argv[1:]))
