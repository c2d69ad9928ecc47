"""Process-group bring-up for runs across ranks.

Port of portfoliooptgp_tpu/parallel/distributed.py on `torch.distributed`.
Call `initialize()` once per process before building a mesh
(parallel/mesh.py). The rendezvous comes from the arguments or from the
environment, in either of two dialects:

- the JAX package's: COORDINATOR_ADDRESS (host:port, or a URL such as
  `file:///path`), NUM_PROCESSES, PROCESS_ID;
- torchrun's: MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK.

Each rank runs on one device: `cuda:LOCAL_RANK` (set with
`torch.cuda.set_device` before the group is made) or the CPU. The backend
is `nccl` on the card and `gloo` on the CPU unless `backend=` names one;
NCCL cannot put two ranks on one card, so ranks that share a card ask for
gloo by name. A failed initialization raises.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from portfoliooptgp_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _env_int(*names) -> Optional[int]:
    for name in names:
        value = os.getenv(name)
        if value not in (None, ""):
            return int(value)
    return None


def _rank_device(device=DEFAULT_DEVICE, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device: the CPU, or the card `local_rank` (default
    LOCAL_RANK, else 0), made the current CUDA device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = dev.index
    if index is None:
        index = local_rank if local_rank is not None else (_env_int("LOCAL_RANK") or 0)
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=DEFAULT_DEVICE,
               backend: Optional[str] = None, local_rank: Optional[int] = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """`init_process_group` from the arguments or the environment; returns
    this rank's device. A no-op (apart from choosing the device) in a
    single-process run, where no address is given, and when the default
    group already exists. `timeout_s` bounds every collective's wait."""
    dev = _rank_device(device, local_rank)
    if dist.is_initialized():
        return dev
    address = coordinator_address or os.getenv("COORDINATOR_ADDRESS")
    world = num_processes if num_processes is not None else _env_int("NUM_PROCESSES",
                                                                     "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("PROCESS_ID", "RANK")
    if address is None and os.getenv("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.getenv('MASTER_PORT', '29500')}"
    if address is None and world is None:
        return dev  # single-process run
    if address is None or world is None or rank is None:
        raise ValueError("a multi-process run needs an address, a world size and a rank "
                         f"(got {address!r}, {world!r}, {rank!r})")
    init_method = address if "://" in address else f"tcp://{address}"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if timeout_s is None else dict(timeout=datetime.timedelta(seconds=timeout_s))
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank), **kw)
    return dev


def is_primary() -> bool:
    """True on rank 0, and in a single-process run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank, fn, world, init_method, device, backend, timeout_s, args):
    dev = torch.device(device)
    local = rank % torch.cuda.device_count() if dev.type == "cuda" and dev.index is None else None
    initialize(init_method, world, rank, device=device, backend=backend, local_rank=local,
               timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device=DEFAULT_DEVICE, backend: Optional[str] = None,
          timeout_s: float = 600.0) -> None:
    """Run `fn(rank, world, *args)` in `world` new (spawned) processes, each
    with the default process group initialized over a file rendezvous in a
    temporary directory: rank i on `device` ("cuda" puts it on card
    i mod the card count, "cuda:0" every rank on card 0) with `backend`
    (default: nccl on a card, gloo on the CPU). `fn` must be importable by
    name. Returns when every rank has finished; raises if any rank raised
    or died, after the others are stopped."""
    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="pgp-rendezvous-")
    try:
        mp.spawn(_rank_main, nprocs=world, join=True,
                 args=(fn, world, "file://" + os.path.join(root, "store"), str(device),
                       backend, timeout_s, args))
    finally:
        shutil.rmtree(root, ignore_errors=True)
