"""Random sources of the samplers: one stream of draws per chain.

The JAX package threads `jax.random` keys through its samplers; torch
cannot repeat them, and its idiom is an explicit `torch.Generator`. A
source stands for the batch of C per-chain keys and offers what the
samplers draw with:

- `split(n)`: n sources, as `jax.random.split(key, n)` per chain;
- `normal(shape, dtype)`: (C, *shape) standard normals;
- `uniform(dtype)`: (C,) uniforms on [0, 1);
- `bernoulli()`: (C,) fair coin flips;
- `where(active, old)`: this source for the chains where `active` holds
  and `old` for the rest, as the chain vmap of a `while_loop` keeps a
  finished chain's key.

`GeneratorSource` draws every chain's values from one generator, so its
`split` and `where` are trivial: the generator's state moves on with each
draw, and a frozen chain's draws are discarded. Another implementation
(one that replays `jax.random` keys) makes the samplers repeat the JAX
package's draws exactly.
"""

from __future__ import annotations

import torch


class GeneratorSource:
    """C chains' draws from one `torch.Generator` on their device."""

    def __init__(self, chains: int, generator: torch.Generator):
        self.chains = int(chains)
        self.generator = generator
        self.device = generator.device

    def split(self, n: int):
        return [self] * n

    def normal(self, shape, dtype):
        return torch.randn((self.chains, *shape), generator=self.generator,
                           device=self.device, dtype=dtype)

    def uniform(self, dtype=None):
        return torch.rand((self.chains,), generator=self.generator, device=self.device,
                          dtype=dtype or torch.get_default_dtype())

    def bernoulli(self):
        return self.uniform(torch.float32) < 0.5

    def where(self, active, old):
        return self
