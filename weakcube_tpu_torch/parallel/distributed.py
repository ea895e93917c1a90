"""Processes of a data-parallel run (weakcube_tpu/parallel/distributed.py).

The JAX package drives every local device from one process (one controller
per host, SPMD over a mesh that spans the hosts after
`jax.distributed.initialize`). The port runs one process per card, the
PyTorch idiom: a difference by design. Each process is one rank of a
`torch.distributed` group (NCCL between cards, gloo on the CPU), holds a
replica of the model and trains on its rows of every global batch
(parallel/mesh.py, parallel/train_step.py).

Where the ranks come from:
  * one host, no variables set: `launch(fn, n)` spawns n processes, one per
    local card (`TPU.MESH_SHAPE [-1]`: every visible card), which meet at
    tcp://localhost:<a free port>;
  * several hosts, one command per host, as in the JAX package:
        WEAKCUBE_COORDINATOR=<host0>:<port> WEAKCUBE_NUM_PROCESSES=<hosts> \
        WEAKCUBE_PROCESS_ID=<host index> python -m weakcube_tpu_torch.tools.train_net ...
    each host launches its local cards; host h's card c is rank
    h * cards + c of hosts * cards, and rank 0 serves the rendezvous;
  * WEAKCUBE_MULTIHOST=1 (the counterpart of JAX's auto-detection): a
    launcher started this process as one rank, and its environment says
    which: torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT, or SLURM's SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID
    (with MASTER_ADDR, else SLURM_LAUNCH_NODE_IPADDR, and MASTER_PORT).
At world size 1 nothing is initialised and every helper here is trivial.

Beside the data-parallel group each process joins a gloo group for host
objects (evaluation records, logs, timings): NCCL moves tensors on cards
only and has no object gather. A collective that waits longer than the
group's timeout raises, so a rank that dies or hangs stops the run.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import pickle
import socket
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

TIMEOUT = datetime.timedelta(minutes=30)  # a collective waiting longer raises

_LOCAL_RANK = 0
_HOST_GROUP = None  # gloo group of every rank, for host objects


@dataclasses.dataclass(frozen=True)
class Rendezvous:
    """Where and as what this host's processes join the group: ranks
    rank_base .. rank_base + local_count - 1 of `world`."""
    address: str          # tcp://host:port of rank 0's store
    world: int
    rank_base: int
    local_count: int


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rendezvous_from_env(env: Mapping[str, str], local_count: int) -> Optional[Rendezvous]:
    """The rendezvous the WEAKCUBE_* variables describe (see the module
    docstring), for a host that runs `local_count` processes; None without
    them. WEAKCUBE_MULTIHOST describes one process (local_count 1)."""
    coord = env.get("WEAKCUBE_COORDINATOR")
    if coord:
        hosts, host = int(env["WEAKCUBE_NUM_PROCESSES"]), int(env["WEAKCUBE_PROCESS_ID"])
        if not 0 <= host < hosts:
            raise ValueError(f"WEAKCUBE_PROCESS_ID {host} is not in [0, {hosts})")
        return Rendezvous(f"tcp://{coord}", hosts * local_count, host * local_count, local_count)
    if env.get("WEAKCUBE_MULTIHOST"):
        if "RANK" in env:
            rank, world, addr = int(env["RANK"]), int(env["WORLD_SIZE"]), env["MASTER_ADDR"]
        elif "SLURM_PROCID" in env:
            rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
            addr = env.get("MASTER_ADDR") or env["SLURM_LAUNCH_NODE_IPADDR"]
        else:
            raise RuntimeError("WEAKCUBE_MULTIHOST is set but neither torchrun's RANK / "
                               "WORLD_SIZE nor SLURM's SLURM_PROCID / SLURM_NTASKS are")
        return Rendezvous(f"tcp://{addr}:{env.get('MASTER_PORT', '29500')}", world, rank, 1)
    return None


def local_rank_from_env(env: Mapping[str, str]) -> int:
    """This process's card on its host under WEAKCUBE_MULTIHOST."""
    return int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", "0")))


def processes_for(mesh_shape: Sequence[int], device_type: str) -> int:
    """The local process count of cfg.TPU.MESH_SHAPE, one data axis: -1 is
    every visible card (the CPU is one device); an explicit count on the
    CPU runs that many gloo processes."""
    shape = list(mesh_shape or [-1])
    if len(shape) != 1:
        raise ValueError(f"TPU.MESH_SHAPE {shape}: the port is data-parallel only, one axis")
    n = shape[0]
    if n == -1:
        return torch.cuda.device_count() if device_type == "cuda" else 1
    if n < 1:
        raise ValueError(f"TPU.MESH_SHAPE {shape}: the data axis must be -1 or positive")
    if device_type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"TPU.MESH_SHAPE {shape} asks for {n} cards, "
                         f"{torch.cuda.device_count()} are visible")
    return n


def initialize(address: str, world: int, rank: int, local_rank: int, device_type: str) -> None:
    """Join the data-parallel group as `rank` of `world` (NCCL for cards,
    gloo on the CPU) and the gloo group for host objects. A card's rank
    works on cuda:local_rank."""
    global _LOCAL_RANK, _HOST_GROUP
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
    backend = "nccl" if device_type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    _LOCAL_RANK = local_rank
    _HOST_GROUP = dist.new_group(backend="gloo", timeout=TIMEOUT) if backend != "gloo" \
        else dist.group.WORLD
    logger.info("distributed: rank %d of %d (%s, local rank %d)", rank, world, backend,
                local_rank)


def shutdown() -> None:
    global _LOCAL_RANK, _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_RANK, _HOST_GROUP = 0, None


def maybe_initialize_distributed(device_type: str) -> bool:
    """Join the group that WEAKCUBE_MULTIHOST's launcher describes (one
    rank per process). Returns True when this process is one rank of
    several; without the variable it does nothing and returns False."""
    if dist.is_initialized():
        return True
    if not os.environ.get("WEAKCUBE_MULTIHOST"):
        return False
    rdv = rendezvous_from_env(os.environ, 1)
    initialize(rdv.address, rdv.world, rdv.rank_base, local_rank_from_env(os.environ),
               device_type)
    return True


def is_main_process() -> bool:
    """Rank 0 does the host-side writes (checkpoints, metrics.json, console
    logs, JPEGs) -- the reference's comm.is_main_process()."""
    return rank() == 0


def process_count() -> int:
    """The number of ranks (1 when nothing is initialised)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return _LOCAL_RANK


def barrier() -> None:
    if process_count() > 1:
        dist.barrier(group=_HOST_GROUP)


def gather_objects(obj: Any) -> Optional[List[Any]]:
    """Every rank's `obj`, in rank order, on rank 0 (None elsewhere), over
    the gloo group."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0, group=_HOST_GROUP)
    return out


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank, over the gloo group."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def _run_rank(local: int, fn: Callable, args: tuple, rdv: Rendezvous, device_type: str,
              results) -> None:
    if device_type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // rdv.local_count))
    initialize(rdv.address, rdv.world, rdv.rank_base + local, local, device_type)
    try:
        out = fn(*args)
        if local == 0:
            # plain pickle bytes: torch's own queue pickling would hand
            # tensors over in this process's shared memory, gone once it exits
            results.put(pickle.dumps(out))
    finally:
        shutdown()


def launch(fn: Callable, n: int, args: tuple = (), device_type: str = "cuda") -> Any:
    """Run fn(*args) in n spawned processes, one per local card (or n gloo
    processes on the CPU), as ranks of one group: this host's part of the
    WEAKCUBE_COORDINATOR rendezvous, else all of one on localhost. Returns
    what local rank 0's fn returned. A rank that raises or exits stops the
    others, and the error is raised here."""
    import torch.multiprocessing as mp
    rdv = rendezvous_from_env(os.environ, n) if os.environ.get("WEAKCUBE_COORDINATOR") \
        else Rendezvous(f"tcp://localhost:{free_port()}", n, 0, n)
    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_run_rank, args=(fn, args, rdv, device_type, results),
                             nprocs=n, join=False, start_method="spawn")
    out = None
    # drain the queue while waiting: a large result would block its writer
    while not ctx.join(timeout=0.5):
        while not results.empty():
            out = results.get()
    while not results.empty():
        out = results.get()
    return None if out is None else pickle.loads(out)
