"""Time the stationary NLL kernel of one or more checkouts on the card, in turns.

    python tools/stationary_compare.py ROOT [ROOT ...]

Each ROOT is the root of a checkout of the repository: `.`, or another
commit unpacked by `git archive` into a directory that .gitignore lists
(`build/parent`, say). Each ROOT runs in a process of its own, with that
checkout's `portfoliooptgp_tpu_torch` first on the path, so its
`csrc/stationary_nll.cu` is built into its own `build/kernels/`. The times
are taken by this checkout's `chip_smoke.stationary_times` at every shape of
`chip_smoke.STATIONARY_TIMED` (the walk-forward's (5, 77) masked, the
headline's (128, 256), the weekly and monthly menus' (1, 175) and (1, 40),
frontier grid A's (20, 262), the NUTS posterior's (8, 512) ARD, grid A's
ICM under two NUTS chains (40, 262) and a two-year walk-forward's (5, 480)
masked): the kernel with and without W,
its plain version and the torch.linalg chain by CUDA-graph replay, the
kernel and the chain eager, and the bound; chip_smoke phase 3's headline
value+grad through the router; and the one-year frontier pipeline (grid A,
N = 262) warm under the profiler: its wall and device seconds, the
stationary kernel's seconds and launches. Name the roots in turns (parent,
change, change, parent) to compare two commits on one card. Prints one JSON
line per ROOT, then the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dense_compare import HERE, run_in_turns  # noqa: E402


def times_of(root: str) -> dict:
    """This process: put `root`'s package first on the path and time its
    kernel with this checkout's chip_smoke."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts this checkout on the path: `root` goes before it
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from portfoliooptgp_tpu_torch.ops import stationary_nll as st

    if not torch.cuda.is_available():
        raise SystemExit("stationary_compare: needs a CUDA device")
    if not os.path.abspath(st.__file__).startswith(os.path.abspath(root) + os.sep):
        raise SystemExit(f"stationary_compare: imported {st.__file__}, not {root}'s")
    times = {label: cs.stationary_times(st, *shape)
             for label, shape in cs.STATIONARY_TIMED.items()}
    times["headline value+grad ms"] = headline_value_grad_ms(cs)
    times["frontier 1y profiled"] = frontier_profile(cs, st, root)
    return times


def frontier_profile(cs, st, root) -> dict:
    """The one-year frontier pipeline (chip_smoke phase 8's grid A: the ICM
    fit's NLL on the stationary kernel at B = 20, N = 262) with the package
    first on the path: a cold run, then a warm run under the profiler
    (`chip_smoke.device_busy`, which writes the device time by name to
    frontier_1y_<root>.txt): wall, device and stationary-kernel seconds, and
    the stationary kernel's launches in the warm run."""
    with open(cs.frontier_goldens_path("1y")) as fh:
        g = json.load(fh)
    with open(cs.frontier_goldens_path("1y", True)) as fh:
        g32 = json.load(fh)
    with tempfile.TemporaryDirectory() as data:
        cs.make_frontier_market(data, *cs.FRONTIER_GRIDS["1y"], seed=g["market_seed"])
        cs.run_frontier(data, "1y", g, g32, "cuda", replay=False)
        before = st.kernel_launches()
        name = "frontier_1y_" + "".join(ch if ch.isalnum() else "_" for ch in root) + ".txt"
        busy = cs.device_busy(lambda: cs.run_frontier(data, "1y", g, g32, "cuda", replay=False),
                              name, kernel="stationary_nll")
        after = st.kernel_launches()
    return dict(busy, launches=sum(after.values()) - sum(before.values()))


def headline_value_grad_ms(cs) -> dict:
    """chip_smoke phase 3's headline value+grad (B = 128 SE models, N = 256,
    through the router's fused_stationary tier) with the package first on
    the path: eager, by CUDA events around back-to-back calls, and the
    device time of one call and the stationary kernel's part of it, under
    the profiler (`chip_smoke.value_grad_device_ms`)."""
    import torch

    from portfoliooptgp_tpu_torch.models import gpr
    from portfoliooptgp_tpu_torch.params import tree_leaves, tree_map

    stacked, X, Y = cs._headline_problem()
    stacked = tree_map(lambda x: x.requires_grad_(True), stacked)
    leaves = tree_leaves(stacked)

    def value_and_grad():
        nll = gpr.batched_neg_log_marginal_likelihood(stacked, X, Y, device="cuda")
        return torch.autograd.grad(nll.sum(), leaves)

    return dict(eager=cs.cuda_ms(value_and_grad, reps=20), **cs.value_grad_device_ms(value_and_grad))


if __name__ == "__main__":
    sys.exit(run_in_turns(__file__, times_of, sys.argv[1:]))
