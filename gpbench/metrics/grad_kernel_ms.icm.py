"""Device milliseconds of the NLL backward's kernels a backward: the traced seconds of the kernels whose name holds stationary_nll_grad (stationary_nll_grad_alpha, then stationary_nll_grad_kernel, one each a backward) ÷ the launches of stationary_nll_grad_kernel; nothing where the program has no such kernel."""

from gpbench import readers


def read(run):
    launches, _ = readers._kernel(run, "stationary_nll_grad_kernel")
    _, seconds = readers._kernel(run, "stationary_nll_grad")
    return 1e3 * seconds / launches if launches else None
