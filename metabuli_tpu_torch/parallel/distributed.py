"""Multi-process execution on ``torch.distributed``.

Counterpart of ``metabuli_tpu.parallel.distributed``: every process joins
one process group (``initialize``), the (data, db) grid spans the
processes, one cell each (``global_mesh``), every process loads the DB and
builds only its own db shard on its device (``distribute_index``), and
takes its data row's slice of each global batch (``distribute_reads``).
The db axis's collectives ride NCCL between cards, or gloo through pinned
host buffers where several ranks share one card (NCCL refuses that).

Usage (per process):

    from metabuli_tpu_torch.parallel import distributed as dist
    mesh = dist.global_mesh(n_db, *dist.initialize(
        "host0:1234", num_processes=N, process_id=i))

A one-process run without a backend makes no process group: its mesh
holds every db shard on its one device.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from ..csrc import build
from .mesh import Mesh, shard_index_aa_aligned

BACKENDS = ("nccl", "gloo")
# how long a collective waits for a rank before the run fails
TIMEOUT = datetime.timedelta(minutes=30)


def rank_device(device: str, process_id: int) -> torch.device:
    """A rank's device: ``cuda:<process_id % cards>`` for "cuda" (raises
    without a card), or the one asked for."""
    dev = build.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize(coordinator: str | None = None, num_processes: int = 1,
               process_id: int = 0, backend: str | None = None,
               device: str = "cuda"):
    """Join the process group over ``tcp://<coordinator>`` (host:port) when
    there are several processes or a backend is asked for: NCCL for a card,
    gloo for the CPU unless ``backend`` says otherwise (gloo on a card
    moves the collectives through pinned host buffers). A failing
    backend fails the run: there is no other to fall back on. Returns
    (device, backend or None, world size, rank)."""
    dev = rank_device(device, process_id)
    if num_processes <= 1 and not backend:
        return dev, None, 1, 0
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if not coordinator:
        raise ValueError("a process group needs --coordinator host:port")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside "
                         f"0..{num_processes - 1}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return dev, backend, num_processes, process_id


def shutdown():
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def global_mesh(n_db: int | None, device: torch.device,
                backend: str | None = None, world: int = 1,
                rank: int = 0) -> Mesh:
    """The (data, db) grid over the processes, rank r at (r // n_db,
    r % n_db), with a group of each data row's ranks for the db axis
    (every process makes every group, in one order). ``n_db`` defaults
    to the reference package's rule: 2 when the processes are an even
    number of at least 4, else 1. Without a backend the one process holds
    a (1, n_db) mesh."""
    if n_db is None:
        n_db = 2 if world % 2 == 0 and world >= 4 else 1
    if n_db < 1:
        raise ValueError(f"--db-shards {n_db}")
    if backend is None:
        return Mesh(1, n_db, device)
    if world % n_db:
        raise ValueError(f"{world} processes not divisible by "
                         f"--db-shards {n_db}: a process holds one shard")
    n_data = world // n_db
    db_group = None
    for row in range(n_data):
        g = torch.distributed.new_group(
            list(range(row * n_db, (row + 1) * n_db)))
        if row == rank // n_db:
            db_group = g
    return Mesh(n_data, n_db, device, rank=rank, world=world,
                backend=backend, db_group=db_group)


def distribute_index(values: np.ndarray, taxids: np.ndarray, mesh: Mesh,
                     kmer_format: int = 2, reduced: bool = False):
    """This process's shards of the searchable table on its device (every
    process loads the whole DB, as in the reference package): (every
    shard's (first, end) rows, ``Shards``)."""
    return shard_index_aa_aligned(values, taxids, mesh.n_db, kmer_format,
                                  reduced, shards=mesh.db_cols,
                                  device=mesh.device)


def distribute_reads(reads, mesh: Mesh, per_row: int):
    """This data row's slice of a global batch (a ``ReadBatch``): reads
    ``[r * per_row, (r + 1) * per_row)`` of row r and their rows, with
    qids local to the row (the reference package's local qids per data
    row). Returns (that ``ReadBatch``, index of its first read in the
    batch)."""
    lo = mesh.data_row * per_row
    hi = max(lo, min(lo + per_row, len(reads.names)))
    return reads.take(lo, hi), lo
