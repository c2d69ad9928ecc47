"""Where the port's and the JAX package's float64 step-4 walk-forwards
part, on the CPU: `MultiInputGPR.run_step_4()` of the CLI test's asset
(tests/test_torch_cli.py: `make_market`, ASSETS[2], the default
settings) in both packages at each L-BFGS iteration cap given, printing
the largest |Δ| of the next-day means and both means, and at the last
cap each day's final loss and gradient norm in both; then the port's
run at the last cap once more with its CSVs parsed by pandas instead of
the native loader (`read_eod_csv(use_native=False)`), and how far that
moves its means.

    JAX_PLATFORMS=cpu python tools/trace_step4_divergence.py 0 5 10 15 20 200
"""

import functools
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.bench_portfolio_e2e import ASSETS, DATES, FEATURES, make_market  # noqa: E402
from portfoliooptgp_tpu.pipelines import MultiInputGPR as JMultiInputGPR  # noqa: E402
from portfoliooptgp_tpu.train import batched_lbfgs as jbatched  # noqa: E402
from portfoliooptgp_tpu_torch.data import loader  # noqa: E402
from portfoliooptgp_tpu_torch.pipelines import MultiInputGPR as TMultiInputGPR  # noqa: E402
from portfoliooptgp_tpu_torch.train import batched_lbfgs as tbatched  # noqa: E402


def record_fits(fits):
    """Keep each package's last `fit_matrix` result in `fits`."""
    for name, mod in (("JAX", jbatched), ("port", tbatched)):
        def spy(*a, real=mod.fit_matrix, name=name, **kw):
            fits[name] = real(*a, **kw)
            return fits[name]

        mod.fit_matrix = spy


def main(caps) -> int:
    torch.set_num_threads(2)
    fits = {}
    record_fits(fits)
    with tempfile.TemporaryDirectory() as root:
        make_market(root)
        kw = dict(ticker=ASSETS[2], features=FEATURES, data_root=root, **DATES)
        for cap in caps:
            j = np.asarray(JMultiInputGPR(maxiter=cap, **kw).run_step_4().f_mean).ravel()
            t = np.asarray(TMultiInputGPR(maxiter=cap, device="cpu", dtype=torch.float64,
                                          **kw).run_step_4().f_mean).ravel()
            print(f"maxiter {cap}: max |Δ mean| {np.max(np.abs(j - t)):.3g}; JAX {j.tolist()}, "
                  f"port {t.tolist()}", flush=True)
        for name, res in fits.items():
            print(f"maxiter {caps[-1]}, {name}: final losses "
                  f"{np.asarray(res.loss).tolist()}, gradient norms "
                  f"{np.asarray(res.grad_norm).tolist()}", flush=True)
        loader.read_eod_csv = functools.partial(loader.read_eod_csv, use_native=False)
        p = np.asarray(TMultiInputGPR(maxiter=caps[-1], device="cpu", dtype=torch.float64,
                                      **kw).run_step_4().f_mean).ravel()
        print(f"maxiter {caps[-1]}, the port on pandas-parsed CSVs: max |Δ mean| "
              f"{np.max(np.abs(p - t)):.3g} from its native-parsed run, "
              f"{np.max(np.abs(j - p)):.3g} from JAX's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [0, 5, 10, 15, 20, 200]))
