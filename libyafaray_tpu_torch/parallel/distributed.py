"""The process group of a multi-device render (port of
libyafaray_tpu/parallel/distributed.py to torch.distributed).

One process renders on one device.  Every rank parses and compiles the
same scene (the XML is deterministic, so nothing is broadcast), traces
the lanes of its own band of film rows and splats them into a full-size
partial film; the partial films are summed (`all_reduce`) wherever the
render reads the film: the adaptive flags, autosave, the result.  Photon
passes split their lanes the same way and gather the stored photons, in
lane order, into one identical map on every rank.  QMC streams are keyed
by pixel and photon lane, so a sharded render equals the one-device
render but for the float order of the sums (`mesh.py`).

Backend rule, explicit and logged: NCCL when every rank of a host has a
card of its own, gloo otherwise (the CPU, or several ranks on one card).
Gloo has no all_gather of CUDA tensors, so under gloo every collective
stages its tensor through host memory.

The reference's `put_global` (placing a host array onto a multi-process
sharding) and `_compile_barrier` (a rendezvous after XLA compiles) have no
counterpart here: a rank's tensors are its own, and nothing is compiled
(the CUDA kernels are built before ranks start, `prebuild_kernels`).
"""
from __future__ import annotations

import datetime
import logging
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("libyafaray_tpu_torch")

# seconds a collective waits for a peer before the rank raises: a dead or
# hung rank fails the run instead of stalling it
DEFAULT_TIMEOUT_S = 600.0


def choose_backend(device: str, local_world: int) -> str:
    """NCCL when the ranks render on cards and this host has one for each
    of its local_world ranks, else gloo."""
    if (torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def is_live() -> bool:
    """Whether a process group of more than one rank is initialised."""
    return dist.is_initialized() and dist.get_world_size() > 1


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     device: str = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Initialise the process group from the arguments, or from torchrun's
    environment where they are None (RANK, WORLD_SIZE, LOCAL_WORLD_SIZE,
    MASTER_ADDR / MASTER_PORT through init_method "env://").  Returns
    whether a group of more than one rank is live; a world of one
    initialises nothing.  The backend is `choose_backend`'s for `device`,
    and logged."""
    if dist.is_initialized():
        return is_live()
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    if world_size <= 1:
        return False
    rank = int(env.get("RANK", 0)) if rank is None else rank
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = choose_backend(device, local_world)
    msg = (f"distributed: rank {rank}/{world_size}, backend {backend} "
           f"({local_world} ranks on this host, "
           f"{torch.cuda.device_count()} cards; NCCL when each rank has a "
           "card of its own, else gloo)")
    log.info(msg)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device: str = "cuda") -> torch.device:
    """This rank's device: the CPU, or card LOCAL_RANK modulo the cards
    (ranks that outnumber the cards share them)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % n)


def _staged(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() == "gloo"


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of t, as a new tensor on t's device (t itself
    is left as it was)."""
    x = t.detach().to("cpu", copy=True) if _staged(t) else t.clone()
    dist.all_reduce(x)
    return x.to(t.device)


def all_gather(t: torch.Tensor) -> list:
    """Every rank's t (equal shapes), in rank order, on t's device."""
    x = t.detach().cpu() if _staged(t) else t.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x)
    return [o.to(t.device) for o in out]


def _scalar_device() -> torch.device:
    """Where a small collective's tensor lives: NCCL takes only the card
    (set by init_distributed), gloo the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_flag(flag: bool) -> bool:
    """Rank 0's flag on every rank (decisions taken on one rank's clock)."""
    x = torch.tensor([int(flag)], dtype=torch.int32,
                     device=_scalar_device())
    dist.broadcast(x, 0)
    return bool(x.item())


def barrier() -> None:
    """Wait for every rank of the live group."""
    if is_live():
        dist.barrier()


# ---- local ranks ------------------------------------------------------------

def prebuild_kernels() -> None:
    """Build every CUDA kernel library before local ranks start, one nvcc
    a source, all at once, so no two ranks build the same library."""
    from ..ops import _build

    with ThreadPoolExecutor(len(_build.CUDA_SOURCES)) as pool:
        list(pool.map(_build.build, _build.CUDA_SOURCES))


def _rank_main(rank: int, world: int, store: str, device: str,
               threads: int, timeout_s: float, fn, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    init_distributed(f"file://{store}", world, rank, device,
                     timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), device: str = "cuda",
                threads: int | None = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run fn(rank, *args) in `world` new processes (the spawn method: a
    CUDA context cannot be forked), each a rank of one group initialised
    through a file store in a temporary directory, with `threads` torch
    threads (default this process's share).  fn must be importable by
    name.  Waits for every rank; when any exits non-zero the others are
    ended and this raises (torch.multiprocessing's ProcessRaisedException
    or ProcessExitedException), so a dead rank fails the run, and a rank
    whose peer hangs raises after timeout_s in its collective."""
    if threads is None:
        threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="libyaf_ranks_") as d:
        torch.multiprocessing.start_processes(
            _rank_main, args=(world, os.path.join(d, "store"), device,
                              threads, timeout_s, fn, args),
            nprocs=world, join=True, start_method="spawn")


def render_sharded_global(cscene, cfg, mesh=None, n_steps: int | None = None,
                          device: str = "cuda") -> dict:
    """`mesh.render_sharded` on every rank of the live group (mesh None:
    `make_device_mesh` over it): this rank traces its band, the partial
    films are summed, and every rank returns the full film as host (numpy)
    planes."""
    from .mesh import make_device_mesh, render_sharded

    if mesh is None:
        mesh = make_device_mesh(height=cfg.height, device=device)
    film = render_sharded(cscene, cfg, mesh, n_steps)
    return {k: np.asarray(v.detach().cpu()) for k, v in film.items()}
