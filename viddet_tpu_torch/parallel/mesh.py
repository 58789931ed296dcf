"""Process groups and the data-parallel helpers (counterpart of
``viddet_tpu/parallel/mesh.py``).

JAX's train step is one SPMD program over the ``data`` axis of a device
mesh: batches split along it, parameters replicated, and XLA derives the
rest.  The port runs one process per card under ``torch.distributed``
(NCCL for CUDA tensors, gloo for CPU tensors), started by torch's own
launcher:

    python -m torch.distributed.run --nproc_per_node=N \\
        -m viddet_tpu_torch.cli.train_yolov3 ...

(add ``--platform cpu`` for gloo ranks on the CPU).  Each process loads
its own strided shard of one shuffled order (``DetectionLoader(shard=
(process_index(), process_count()))``), holds a full replica of the model,
and the global batch is the processes' local batches concatenated in
process order, as JAX's ``make_array_from_process_local_data`` assembles
it.  What GSPMD derives from the one program the port does by hand:

* train-mode BatchNorm normalizes with the global batch's statistics
  (``models/common.py`` ``batch_norm_train``);
* the gradients are averaged over the processes before the update, and
  the returned losses are the global batch's (``train/state.py``,
  ``train/loop.py``);
* Faster R-CNN divides its losses by global counts, and its samplers draw
  the global batch's uniforms and keep their own rows (``global_uniform``).

No ``DistributedDataParallel``: it renames every parameter ``module.*``,
which the ``.npz`` schema, the checkpoints and ``TrainState`` refuse.
Without a process group every function here is the one-process identity.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from datetime import timedelta
from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
LOG = logging.getLogger("viddet_tpu_torch.parallel")
# Environment variables that name a job of several processes when > 1.
COUNT_MARKERS = ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")


def _marker() -> Optional[str]:
    for name in COUNT_MARKERS:
        try:
            if int(os.environ.get(name, "")) > 1:
                return name
        except ValueError:
            pass
    return None


def local_rank() -> int:
    """This process's card on its host (torch's launcher sets ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the job's process group; call once at program start in every
    process.

    ``coordinator_address`` is ``host:port`` (TCP), or an init URL such as
    ``file:///path`` or ``tcp://host:port``; without one torch's launcher
    environment is read (``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  ``num_processes`` / ``process_id`` override
    ``WORLD_SIZE`` / ``RANK``.  ``backend`` None is NCCL where CUDA is
    available, else gloo; gloo also takes CUDA tensors (several ranks on
    one card, which NCCL refuses).  Under NCCL the process first selects
    its card, ``cuda:{LOCAL_RANK}``.  ``timeout_s`` bounds the rendezvous
    and every collective.

    JAX's rule: a second call is a logged no-op, and so is a plain single
    process (no coordinator requested, no multi-process marker).  A failed
    initialization where a coordinator is given or a marker says the job
    has several processes (``WORLD_SIZE``, ``SLURM_NTASKS`` or
    ``OMPI_COMM_WORLD_SIZE`` > 1, or ``num_processes`` > 1) raises
    RuntimeError: falling back to one process would train each process
    alone, silently wrong."""
    if dist.is_initialized():
        LOG.info("torch.distributed already initialized; skipping")
        return
    marker = _marker()
    explicit = coordinator_address is not None or (num_processes or 1) > 1 or marker is not None
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address or "env://"
    if "://" not in url:
        url = f"tcp://{url}"
    world = num_processes
    if world is None and (url != "env://" or "WORLD_SIZE" in os.environ):
        world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id
    if rank is None and world is not None:
        rank = int(os.environ.get("RANK", "0"))
    try:
        if world is not None and (world < 1 or not 0 <= rank < world):
            raise ValueError(f"process {rank} of {world} is not a valid place in a job")
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        kw = {} if world is None else {"world_size": world, "rank": rank}
        dist.init_process_group(backend, init_method=url, timeout=timedelta(seconds=timeout_s),
                                **kw)
    except (RuntimeError, ValueError) as e:
        if explicit:
            raise RuntimeError(
                "torch.distributed initialization failed with a coordinator configured "
                f"(arg={coordinator_address!r}, env marker={marker!r}); refusing to fall back "
                "to one process") from e
        LOG.info("single-process environment (no coordinator): %s", e)
        return
    LOG.info("torch.distributed initialized: process %d/%d, backend %s", dist.get_rank(),
             dist.get_world_size(), backend)


def active() -> bool:
    """Whether a process group is up (at any world size)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if active() else 0


def process_count() -> int:
    return dist.get_world_size() if active() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D ``data`` axis: ``size`` processes, this one at ``rank``, its
    replica on ``device``."""

    size: int
    rank: int
    device: torch.device


def make_mesh(device: torch.device) -> Mesh:
    """The job's data axis, with this process's replica on ``device``."""
    return Mesh(process_count(), process_index(), torch.device(device))


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """This process's rows of a global batch (dim 0 split evenly in
    process order): the port's reading of JAX's ``P(DATA_AXIS)``."""
    size, rank = process_count(), process_index()
    if x.shape[0] % size:
        raise ValueError(f"a global batch of {x.shape[0]} does not split over {size} processes")
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def global_uniform(local_shape: Sequence[int], generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """Uniforms of the global batch, this process's rows: ``torch.rand`` of
    (B_local * processes, ...) from ``generator``, then rows [rank * B_local,
    (rank + 1) * B_local).  Every process seeds its generator alike, so the
    global batch is drawn as one process with the whole batch draws it (the
    draw rule; JAX draws the global batch from one key)."""
    shape = (local_shape[0] * process_count(),) + tuple(local_shape[1:])
    return shard_batch(torch.rand(shape, generator=generator, device=device))


@torch.no_grad()
def _in_buckets(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective(flat)`` on one flat copy of ``tensors`` per dtype and
    device, copied back into them: one collective a bucket, not a tensor."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def all_reduce_(tensors: Sequence[torch.Tensor], mean: bool = False) -> None:
    """Sum (or average) ``tensors`` over the processes in place: an
    ``all_reduce`` (SUM) a bucket, then ``/ processes`` for the mean.  Runs
    whenever a group is up, at world size 1 too (a sum of one, exact)."""
    if not active():
        return
    world = dist.get_world_size()

    def reduce(flat):
        dist.all_reduce(flat)
        if mean and world > 1:
            flat /= world

    _in_buckets(tensors, reduce)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(processes, *x.shape): every process's ``x`` in process order, by one
    ``all_reduce`` of a zero-filled stack holding this process's row (gloo
    takes no ``all_gather`` of CUDA tensors; adding zeros is exact)."""
    rows = x.new_zeros((dist.get_world_size(),) + tuple(x.shape))
    rows[dist.get_rank()] = x
    dist.all_reduce(rows)
    return rows


def replicate(model: torch.nn.Module, extra: Iterable[torch.Tensor] = ()) -> None:
    """Broadcast the parameters and buffers of ``model`` (and ``extra``, say
    the momentum buffers) from process 0, in place: run once after
    initialization or a resume, so the replicas cannot start apart."""
    if process_count() > 1:
        _in_buckets([*model.parameters(), *model.buffers(), *extra],
                    lambda flat: dist.broadcast(flat, src=0))


def put_batch(batch: Sequence[np.ndarray], mesh: Mesh) -> tuple:
    """This process's local batch (host arrays) on its device: each array
    one pinned-memory, non-blocking copy on CUDA."""
    from viddet_tpu_torch.infer.service import to_device_batch

    return tuple(to_device_batch(np.ascontiguousarray(x), x.shape[0], mesh.device)
                 for x in batch)


def barrier() -> None:
    """Wait for every process (a no-op without a group of several)."""
    if process_count() > 1:
        nccl = dist.get_backend() == "nccl"
        dist.barrier(device_ids=[torch.cuda.current_device()] if nccl else None)
