"""The benchmark's cells, one module per configuration `kind`.

A kind module's `Cell(config, traffic, seed, device)` sets a cell up and warms
its shapes; `step()` runs one unit of its work and returns how many of
the module's `UNIT` it made; `counters()`, `release()`,
`attempted_failed()`, `outputs()`, `control_outputs(precision)` and
`readings(outputs)` serve the harness and its check; `SPANS` names the
layer entry points that the traced run wraps in spans.
"""

import torch


def stationary_launches(device) -> dict:
    """The stationary NLL kernel's launch counters, on the card only."""
    if torch.device(device).type != "cuda":
        return {}
    from portfoliooptgp_tpu_torch.ops import stationary_nll

    launches = stationary_nll.kernel_launches()
    return {"cluster_launches": launches["cluster"], "tile_launches": launches["tile"]}
