"""Multi-process setup (the port's counterpart of
``mamimo_tpu/parallel/multihost.py``).

Processes join one ``torch.distributed`` process group; a mesh made by
``parallel.mesh.make_mesh`` after ``init`` then spans every process's
ranks (each process names its own ranks, and computes only those), and
the sums of ``parallel/`` cross the processes through the group:

    init()                          # per process, from the environment
    mesh = make_mesh({"data": num_processes * ranks_per_process})

Typical launch (per process):

    MAMIMO_COORDINATOR_ADDRESS=<host0:port> MAMIMO_NUM_PROCESSES=<n> \\
        MAMIMO_PROCESS_ID=<i> python3 train.py

The group's transport is gloo when the ranks are CPUs and NCCL when they
are cards.
"""

from __future__ import annotations

import os

import torch

ENV_ADDRESS = "MAMIMO_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "MAMIMO_NUM_PROCESSES"
ENV_PROCESS_ID = "MAMIMO_PROCESS_ID"


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None,
         backend: str | None = None) -> None:
    """Join the multi-process group (idempotent, env-overridable).

    Reads MAMIMO_COORDINATOR_ADDRESS ("host:port" of process 0),
    MAMIMO_NUM_PROCESSES and MAMIMO_PROCESS_ID when the arguments are
    None, as the JAX package reads JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES and JAX_PROCESS_ID; does nothing without an address
    or with one process, so the same entry points run unchanged in one
    process.

    backend: "gloo" (CPU ranks) or "nccl" (CUDA ranks); None picks NCCL
    when a CUDA device is visible and gloo otherwise. With NCCL each
    process should see, or set as current, the card its ranks are on.
    """
    coordinator_address = coordinator_address or os.environ.get(ENV_ADDRESS)
    if coordinator_address is None:
        return
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get(ENV_NUM_PROCESSES, "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get(ENV_PROCESS_ID, "0"))
    if num_processes <= 1:
        return
    dist = torch.distributed
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def process_count() -> int:
    """The number of joined processes (1 without ``init``)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's index in the group (0 without ``init``)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a batch axis split evenly over the
    processes."""
    n, i = process_count(), process_index()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shutdown() -> None:
    """Leave the group (no-op when none was joined)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
