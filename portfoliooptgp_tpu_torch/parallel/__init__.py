"""Process meshes, sharded losses and training steps across ranks (the JAX
package's parallel/, on torch.distributed)."""

from portfoliooptgp_tpu_torch.parallel import dist_cholesky as dist_cholesky
from portfoliooptgp_tpu_torch.parallel import distributed as distributed
from portfoliooptgp_tpu_torch.parallel import elbo_sharded as elbo_sharded
from portfoliooptgp_tpu_torch.parallel import mesh as mesh
from portfoliooptgp_tpu_torch.parallel.dist_cholesky import sharded_gpr_nll
from portfoliooptgp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    RESTART_AXIS,
    make_mesh,
    replicate,
    shard_batch,
)
