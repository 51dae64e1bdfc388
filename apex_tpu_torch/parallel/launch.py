"""Process bootstrap (``apex_tpu/parallel/launch.py``): the
``torch.distributed.init_process_group`` of the port.

:func:`distributed_env` resolves (coordinator, rank, world size) from the
same environment table as the JAX package: the JAX-native variables
(``COORDINATOR_ADDRESS``, ``PROCESS_ID``, ``NUM_PROCESSES``) first, then
the ones torchrun exports (``MASTER_ADDR`` + ``MASTER_PORT``,
``RANK``/``NODE_RANK``, ``WORLD_SIZE``).  :func:`init_distributed` opens
the process group over ``tcp://<coordinator>``.

Backends: ``"nccl"`` for ranks on CUDA devices, ``"gloo"`` on the CPU or
when the caller asks for it.  Each rank takes ``cuda:<local rank>``
(``LOCAL_RANK``, else the rank).  Ranks share one card only when the
caller says so (``share_device=True``): rank ``r`` then takes card ``r %
count``; NCCL refuses two ranks on one device, so shared cards take gloo.
With fewer cards than local ranks and no such request, it raises.
Nothing is chosen after a failure: a bad backend, a missing card or a
group that does not form raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "distributed_env", "local_rank",
           "destroy_distributed"]

BACKENDS = ("nccl", "gloo")


def distributed_env(environ=None):
    """Resolve (coordinator, process_id, num_processes) from the
    environment; any field may come back None when unset."""
    env = os.environ if environ is None else environ

    coord = env.get("COORDINATOR_ADDRESS")
    if coord is None and env.get("MASTER_ADDR"):
        port = env.get("MASTER_PORT", "8476")
        coord = f"{env['MASTER_ADDR']}:{port}"

    # RANK (the global torchrun rank) outranks NODE_RANK: with several
    # processes per node only RANK is unique across the job
    pid = env.get("PROCESS_ID", env.get("RANK", env.get("NODE_RANK")))
    nproc = env.get("NUM_PROCESSES", env.get("WORLD_SIZE"))
    return (coord,
            int(pid) if pid is not None else None,
            int(nproc) if nproc is not None else None)


def local_rank(process_id: int, environ=None) -> int:
    """This process's index on its host: ``LOCAL_RANK`` when the launcher
    exports it, else the global rank (one host)."""
    env = os.environ if environ is None else environ
    value = env.get("LOCAL_RANK")
    return int(value) if value is not None else int(process_id)


def _pick_device(device, lrank: int, share_device: bool,
                 backend: str) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("backend 'nccl' needs CUDA devices; the CPU "
                             "takes 'gloo'")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {dev}: expected 'cuda' or 'cpu'")
    if share_device and backend == "nccl":
        raise ValueError(
            "ranks that share a card take backend='gloo': NCCL refuses "
            "two ranks on one device")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' (gloo) to run "
                           "a CPU world")
    if lrank >= count:
        if not share_device:
            raise RuntimeError(
                f"local rank {lrank} but {count} CUDA device(s): each rank "
                "takes its own card; pass share_device=True (with the "
                "'gloo' backend) to let ranks share one")
    return torch.device("cuda", lrank % count)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None, device=None,
                     share_device: bool = False,
                     timeout_s: float = 600.0) -> int:
    """Open this process's group; returns the world size (1, with nothing
    opened, for a single process without a launcher environment).

    Arguments outrank the environment (:func:`distributed_env`).
    ``device`` ``"cuda"`` (default) or ``"cpu"``; ``backend`` defaults to
    ``"nccl"`` on CUDA and ``"gloo"`` on the CPU (and for ranks that share
    a card).  A CUDA rank's device becomes the current one
    (``torch.cuda.set_device``).  A second call after a successful one
    returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    env_coord, env_pid, env_nproc = distributed_env()
    coord = coordinator_address or env_coord
    pid = process_id if process_id is not None else env_pid
    nproc = num_processes if num_processes is not None else env_nproc

    if coord is None:
        if nproc is not None and nproc > 1:
            # a multi-process launch without a coordinator must fail
            # loudly: n independent single-process jobs are the worst case
            raise RuntimeError(
                f"WORLD_SIZE/NUM_PROCESSES={nproc} but no coordinator "
                "address: set COORDINATOR_ADDRESS or MASTER_ADDR[:PORT], "
                "or pass coordinator_address=")
        return 1
    if nproc is not None and nproc <= 1:
        return 1
    if nproc is None or pid is None:
        raise RuntimeError(
            f"coordinator {coord!r} but WORLD_SIZE/RANK gave "
            f"num_processes={nproc} / process_id={pid}: a torch-style "
            "launcher exports all three; set WORLD_SIZE and RANK, or pass "
            "num_processes=/process_id=")
    dev_kind = torch.device("cuda" if device is None else device).type
    if backend is None:
        backend = "nccl" if dev_kind == "cuda" and not share_device \
            else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    dev = _pick_device(device, local_rank(pid), share_device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def destroy_distributed() -> None:
    """Close the process group :func:`init_distributed` opened (a no-op
    without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
