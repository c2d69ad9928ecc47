"""Host milliseconds of the closed-form NLL backward a call: total time of the program's span nll.backward ÷ its count (one a leaf, the single-family backward here)."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    backward = getattr(profiling, "SPANS", {}).get("nll.backward")
    return backward[1] * 1e-6 / backward[0] if backward else None
