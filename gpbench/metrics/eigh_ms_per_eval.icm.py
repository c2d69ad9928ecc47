"""Host milliseconds of the batched eigh of B an ICM evaluation, forward and backward: total time of the program's spans linalg.eigh and linalg.eigh_backward ÷ count(icm.nll)."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    spans = getattr(profiling, "SPANS", {})
    nll, fwd, bwd = (spans.get(k) for k in ("icm.nll", "linalg.eigh", "linalg.eigh_backward"))
    if not nll or not fwd:
        return None
    return (fwd[1] + (bwd[1] if bwd else 0)) * 1e-6 / nll[0]
