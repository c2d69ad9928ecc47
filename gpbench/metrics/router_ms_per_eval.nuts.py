"""Milliseconds of the NLL router an evaluation: total time of the program's span router.dispatch (operands and tier, not the kernel's call) ÷ its count."""

from portfoliooptgp_tpu_torch.utils import profiling


def read(run):
    router = getattr(profiling, "SPANS", {}).get("router.dispatch")
    return router[1] * 1e-6 / router[0] if router else None
