"""Host milliseconds of the ICM model an evaluation up to the kernel's call (B, eigh(B), the rotation of Y, the tier, d2): total time of the program's span icm.nll ÷ its count."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    nll = getattr(profiling, "SPANS", {}).get("icm.nll")
    return nll[1] * 1e-6 / nll[0] if nll else None
