"""Multi-process launch helpers.

Port of ``hybrid9_tpu/parallel/launch.py``, the replacement for the
reference's SLURM + mpirun launch path (EXECUTE/slurm_submit:17-21,71-90;
MPI_INIT at INIT.f90:26-38): one Python process per rank calls
:func:`initialize_distributed`, and a ``torch.distributed`` process group
plays the role of MPI_COMM_WORLD.  Every rank parses the same Config and
owns one contiguous slab of the packed cell axis
(:func:`host_shard_bounds`).

The group runs on gloo: ranks may share one card (NCCL refuses two ranks
on one device), and the CPU runs the same code.  Tensors cross ranks as
host copies, in ``parallel/sharding.py`` only.

    torchrun --standalone --nproc-per-node 2 \\
        -m hybrid9_tpu_torch run --config c.json --shard
    WORLD_SIZE=2 RANK=0 MASTER_ADDR=localhost MASTER_PORT=29500 \\
        python -m hybrid9_tpu_torch run --config c.json --shard   # and RANK=1
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log = get_logger(__name__)

#: Seconds a collective (or the group's rendezvous) waits for its peers
#: before it raises: a rank whose peer hung exits non-zero instead of
#: waiting for ever (a peer that died closes its sockets, and gloo raises
#: at once).
TIMEOUT_S = 900.0

_device_logged = False


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the process group of a multi-process run.

    The arguments default to torch's launcher variables (``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` read by the ``env://``
    rendezvous, which under ``torchrun`` joins its agent's store), which
    ``torchrun`` sets and plain environment variables can set;
    ``coordinator_address`` (``host:port``) rendezvouses there instead.
    With one process, and when the group already exists, this does
    nothing.
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        log.info("single-process run: skipping torch.distributed")
        return
    if dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method=(f"tcp://{coordinator_address}"
                             if coordinator_address else "env://"),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    log.info("distributed initialised: process %d/%d (gloo, timeout %.0f s)",
             process_id, num_processes, TIMEOUT_S)


def process_count() -> int:
    """Ranks in the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard_bounds(n: int) -> tuple[int, int]:
    """[start, end) slice of the packed cell axis owned by this process.

    The multi-process analog of the per-rank hyperslab each reference
    rank reads for itself (READ_NET_CDF_3DR.f90:95-97): each process
    ingests, integrates and writes only its own cells.
    """
    p = process_count()
    i = process_index()
    if n % p != 0:
        raise ValueError(
            f"padded cell count {n} not divisible by host count {p}; "
            f"set Config.cell_block to a multiple of {p} (cells are "
            f"padded to a cell_block multiple, so any such block size "
            f"makes the shard split exact)")
    per = n // p
    return i * per, (i + 1) * per


def local_device() -> torch.device:
    """This rank's card: ``cuda:{LOCAL_RANK % cards}``, so several ranks
    may share one card; made current and logged once."""
    global _device_logged
    index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    device = torch.device("cuda", index)
    if not _device_logged:
        log.info("process %d/%d runs on %s (%s)", process_index(),
                 process_count(), device, torch.cuda.get_device_name(index))
        _device_logged = True
    return device
